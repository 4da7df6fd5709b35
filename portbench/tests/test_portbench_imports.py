"""The harness and every configuration, traffic and metric file load
nothing whose top-level module name, compared whole, is JAX's or the JAX
package's (the port's name begins with the JAX package's)."""
from __future__ import annotations

import subprocess
import sys

from conftest import ROOT

CODE = r"""
import importlib, json, pathlib, sys
import portbench.run, portbench.program, portbench.check, portbench.control
import portbench.ranks
from portbench import spec
here = pathlib.Path(spec.__file__).parent
bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
for w in bench["workloads"]:
    spec.load_cell(w["name"])
for f in sorted((here / "configs").glob("*.json")) + sorted(
        (here / "traffic").glob("*.json")):
    json.loads(f.read_text())
for f in sorted((here / "metrics").glob("*.py")):
    importlib.import_module("portbench.metrics." + f.stem)
for m in bench["per_layer"]:
    spec.metric_reader(m["name"])
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_harness_loads_no_jax_and_not_the_jax_package():
    out = subprocess.run([sys.executable, "-c", CODE], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    top = set(__import__("json").loads(out.stdout.strip().splitlines()[-1]))
    assert "gpuraytracer_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "gpuraytracer_tpu"}
