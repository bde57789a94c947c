"""Device milliseconds a unit (a scoping cell) of the kernels launched inside the
program's ``mset2.estimate.wt_d`` span, read as ``wt_d_ms.surveil`` reads a batch: the
product X_hat = W^T D (cuBLAS f32) of the cell's estimate."""

from portbench.harness import reader

read = reader("wt_d_ms.surveil")
