"""Multi-device serving: a (dp, tp) mesh of logical devices and the sharding
rules of the LLM (miotts_tpu/parallel/).

One process drives the whole mesh, as in the JAX package: the server's
batch lanes and codec micro-batches spread over the ``dp`` axis, and the
LLM's weights and KV cache split over ``tp`` (Megatron-style), with the
two collectives of ``collectives.py`` between the ranks of a group.
"""

from .mesh import (
    Mesh, TPGroup, make_mesh, llm_weight_shardings, llm_data_shardings, parse_backend_devices,
    replicate_tree, shard_llm_weights,
)

__all__ = ["Mesh", "TPGroup", "make_mesh", "llm_weight_shardings", "llm_data_shardings",
           "parse_backend_devices", "replicate_tree", "shard_llm_weights"]
