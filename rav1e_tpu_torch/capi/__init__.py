"""rav1e-compatible C ABI of the port (librav1e_torch.so).

`build.build()` compiles the shim; `bridge` is the Python side the
embedded interpreter calls into. Reference: librav1e 0.5.1 exported
symbols (SURVEY.md Appendix A.5, rav1e src/capi.rs).
"""

from rav1e_tpu_torch.capi.build import build, lib_path  # noqa: F401
