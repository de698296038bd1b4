"""The native C client bridge (miotts_tpu/bindings): a C ABI client of the
port's HTTP server, the device-app counterpart of the reference's iOS and
Android shims (examples/swiftui/.../MioTTSLocalBridge.h)."""

from .client import MioTPUClient, build_client_lib  # noqa: F401
