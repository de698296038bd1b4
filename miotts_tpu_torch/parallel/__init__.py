"""Multi-device serving and sequence-parallel decodes: a (dp, tp) mesh of
logical devices, the sharding rules of the LLM, and an ("sp",) mesh over
which one codec decode's time axis splits (miotts_tpu/parallel/).

One process drives the whole mesh, as in the JAX package: the server's
batch lanes and codec micro-batches spread over the ``dp`` axis, and the
LLM's weights and KV cache split over ``tp`` (Megatron-style), with the
two collectives of ``collectives.py`` between the ranks of a group. The
``sp`` axis (``--sequence-parallel``) splits a decode's time axis, with
the halos, gathers and reductions of ``sequence.py``.
"""

from .mesh import (
    Mesh, SpMesh, TPGroup, make_mesh, make_sp_mesh, llm_weight_shardings, llm_data_shardings,
    parse_backend_devices, replicate_tree, shard_llm_weights,
)

__all__ = ["Mesh", "SpMesh", "TPGroup", "make_mesh", "make_sp_mesh", "llm_weight_shardings",
           "llm_data_shardings", "parse_backend_devices", "replicate_tree", "shard_llm_weights"]
