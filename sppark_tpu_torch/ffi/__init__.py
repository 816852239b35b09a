"""FFI layer: the C-ABI boundary and the native host core's loader, the
port of sppark_tpu/ffi (rust/src/lib.rs, go/sppark.go):

  * `SpparkError` <-> RustError{code, message} (util/rusterror.h:18); the
    C side strdup's messages, freed through sppark_drop_error_message;
  * `load_source()` <-> the Go bridge's build-on-first-use and dlopen
    (go/sppark.go:165-213), with the `_sppark` symbol table;
  * `cpu_msm()` <-> the host mult_pippenger (msm/pippenger.hpp:220), over
    the port's copy of the native source (sppark_tpu_torch/native/).
"""

from .loader import NativeModule, build, check_error, load_source
from .native import cpu_available, cpu_msm, load

__all__ = ["load", "cpu_msm", "cpu_available",
           "load_source", "build", "NativeModule", "check_error"]
