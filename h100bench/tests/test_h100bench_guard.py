"""The import guard: no module of JAX or of the JAX package may be loaded
in a run's process; the port's name, which begins with the JAX package's,
passes."""

import subprocess
import sys

from h100bench import harness

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
from h100bench import harness, gen, trace, control
import h100bench.generators.fit_resident, h100bench.generators.serve_closed
from h100bench.reference import compare, frontend_ref, mfcc, mlp
from h100bench.work import counts
import asr_using_robust_nn_tpu_torch.train, asr_using_robust_nn_tpu_torch.serve.engine
import asr_using_robust_nn_tpu_torch.frontend.mfcc, asr_using_robust_nn_tpu_torch.constraints
m = harness.load_manifest()
for c in m["configs"]:
    harness.load_json(harness.ROOT / c["file"])
for w in m["workloads"]:
    harness.load_json(harness.HERE / "traffic" / (w["traffic"] + ".json"))
for p in m["per_layer"]:
    harness.load_metric_reader(p["name"])
print(json.dumps(harness.forbidden_loaded()))
"""


def test_h100bench_names_are_compared_whole():
    f = harness.forbidden_loaded
    assert f(["asr_using_robust_nn_tpu_torch", "asr_using_robust_nn_tpu_"
              "torch.ops.cuda_train"]) == []
    assert f(["asr_using_robust_nn_tpu.ops"]) == ["asr_using_robust_nn_tpu"]
    assert f(["jax.numpy", "jaxlib", "flax.linen", "jaxtyping"]) == [
        "flax", "jax", "jaxlib"]


def test_h100bench_harness_imports_load_no_jax():
    res = subprocess.run([sys.executable, "-c",
                          PROBE.format(root=str(harness.ROOT))],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"
