"""Build the native client bridge (miotts_tpu/bindings/build_client.py):

    python -m miotts_tpu_torch.bindings.build_client
"""

from .client import build_client_lib

if __name__ == "__main__":
    out = build_client_lib(verbose=True)
    if out is None:
        raise SystemExit(1)
    print(f"built {out}")
