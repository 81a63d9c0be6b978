"""What the benchmark loads: never JAX nor the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), and a reference that loads nothing of the program."""

import json
import subprocess
import sys

from conftest import BENCH, ROOT

FORBIDDEN = ["jax", "jaxlib", "flax", "optax", "wsl4mis_tpu"]


def _top_level_after(code: str) -> set:
    prog = (f"import sys; sys.path[:0] = [{ROOT!r}, {BENCH!r}]\n" + code
            + "\nimport json; print(json.dumps(sorted({m.split('.')[0] "
              "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_and_the_reference_load_no_jax():
    loaded = _top_level_after(
        "import run\n"
        "run.environment(run.ROOT)\n"
        "from harness import spec, train, infer, trace, check, work, "
        "readers\n"
        "import calibrate, faults\n"
        "for w in spec.cells(spec.load_spec()):\n"
        "    c = spec.find_cell(w)\n"
        "    c.reference_model()\n"
        "    if 'method' in c.traffic:\n"
        "        c.reference_method(); c.optimizer()\n"
        "    [c.metric_reader(m['name']) for m in c.per_layer]\n"
        "import wsl4mis_torch.engine.trainer, wsl4mis_torch.eval.val2d\n")
    assert "wsl4mis_torch" in loaded
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    loaded = _top_level_after(
        "from harness import spec\n"
        "import reference.train, reference.infer, reference.augment\n"
        "for w in spec.cells(spec.load_spec()):\n"
        "    c = spec.find_cell(w)\n"
        "    c.reference_model()\n"
        "    if 'method' in c.traffic:\n"
        "        c.reference_method(); c.optimizer()\n")
    assert "wsl4mis_torch" not in loaded
    assert not loaded & set(FORBIDDEN)
