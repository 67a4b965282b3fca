"""The label network's share of the card's busy time in the traced window:
the device time of the kernels that ``VideoVad`` runs and the prior's
path does not, over the union of every kernel's intervals.

Its kernels are found by parts of their names (``PARTS``), read from
traced runs of ``m2info_av.serve.open`` and ``m2info.serve.open`` (15 s,
seed 4100000001, H100 80GB HBM3, torch 2.11 with CUDA 12.8): the kernels
the first shows and the second does not. The network's kernels that share
a name with the prior's path are left out, so the share is a lower
bound: the clips' upload (``Memcpy HtoD``), their uint8 -> float32 copy,
the division by the pixels' std, the state fills and the cuBLAS GEMMs
(``sm80_xmma_gemm``) of the projection, the head and the LSTM's input
products."""

from benchmark.trace import busy_ns

#: name parts of the label network's own kernels: cuDNN's convolutions,
#: cuDNN's LSTM cell and the small-N cuBLAS GEMM of its recurrent
#: products, the CUTLASS GEMM beside them, and the normalization's
#: subtraction of the mean
PARTS = ("implicit_convolve_sgemm", "fprop_implicit_gemm", "elemWiseRNNcell",
         "gemmSN_TN_kernel", "cutlass_80_simt_sgemm", "CUDAFunctorOnSelf_add")


def read(run):
    lo, hi = run.trace_window
    busy = busy_ns(run.events, run.trace_window) if hi > lo else 0
    own = sum(d for n, _, d in run.events if any(p in n for p in PARTS))
    if busy <= 0 or own <= 0:
        return None
    return 100.0 * own / busy
