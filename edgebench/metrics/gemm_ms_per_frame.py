"""gemm_ms_per_frame: device milliseconds in GEMM kernels per real frame,
over the waves whose kernels the traced interval holds whole.  A GEMM
kernel is one whose name holds one of GEMM_NAMES (cuBLAS's, among them
its ``nvjet`` kernels on Hopper, CUTLASS's, and the port's int8 GEMM)
and none of CONV_NAMES (cuDNN's implicit-GEMM convolutions)."""
GEMM_NAMES = ("gemm", "nvjet", "cutlass", "int8_matmul_kernel")
CONV_NAMES = ("fprop", "conv", "implicit", "dgrad", "wgrad")


def is_gemm(name):
    n = name.lower()
    return any(k in n for k in GEMM_NAMES) and not any(
        k in n for k in CONV_NAMES)


def read(r):
    waves = r.traced_waves()
    frames = sum(w.B for w, _ in waves)
    if not frames:
        return None
    ms = sum(o.end - o.start for _, ops in waves for o in ops
             if is_gemm(o.name)) * 1e3
    return ms / frames
