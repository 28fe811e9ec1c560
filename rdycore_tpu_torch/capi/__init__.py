"""The port's embedded C API: capi.c (the rdytpu_* symbols of the JAX
package's csrc/capi.c, driving rdycore_tpu_torch.capi_bridge) and build.py,
which compiles it, and a host program against it, at first use."""
