"""train_mfu: the model operations of the window's training rows (forward,
dW, dX; the projection is no model work) over the window's seconds, as a
share of the peak of the precision the path's GEMMs run in (the traffic's
`gemm_dtype`, else the configuration's `train_gemm_dtype`: the fused
epoch's)."""

from h100bench.work import counts

PEAK = {"bfloat16": "bf16", "float32": "fp32", "tf32": "tf32"}


def read(run):
    rows = sum(f["rows"] for f in run.facts["fits"])
    flop = counts.step_flop(rows, run.config["dims"])
    dtype = run.traffic.get("gemm_dtype", run.config["train_gemm_dtype"])
    peak = counts.H100_OPS_PER_S[PEAK[dtype]]
    return 100.0 * flop / run.facts["window_s"] / peak
