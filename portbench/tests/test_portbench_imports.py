"""What the benchmark loads: nothing of JAX or of the JAX package anywhere,
and nothing of the program in the plain reference. Top-level module names
are compared whole: the port's name begins with the JAX package's.
Each check runs in a fresh interpreter (CPU)."""

import json
import subprocess
import sys

from portbench import spec

JAX_NAMES = {"jax", "jaxlib", "flax", "diffusionspatialcontrol_tpu"}
PORT = "diffusionspatialcontrol_tpu_torch"


def _loaded(code: str, cwd=spec.ROOT) -> set:
    code = ("import sys\nsys.path[0] = '.'\n" + code
            + "\nimport json\nprint(json.dumps(sorted({m.split('.')[0] "
              "for m in sys.modules})))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=cwd,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_the_harness_and_a_whole_run_load_no_jax(tmp_path):
    """The harness, every module it loads by name, and a whole run of a
    tiny cell through the program on the CPU."""
    code = f"""
import time, io
from portbench import harness, spec, control  # noqa
from portbench.tests import helpers
bench, bench_dir, root = helpers.tiny_bench({str(tmp_path)!r})
for name in [w["name"] for w in bench["workloads"]]:
    cell = spec.Cell(bench, name, bench_dir, root)
    cell.module("reference", cell.config["reference"])
    cell.module("programs", cell.config["program"])
    for m in cell.end_to_end + cell.per_layer:
        cell.reader(m)
# and every reference, program and reader in the tree, a cell's or not
for kind in ("reference", "programs", "metrics"):
    for path in sorted((bench_dir / kind).glob("[!_]*.py")):
        cell.module(kind, path.stem)
cell = spec.Cell(bench, helpers.TINY_CELL, bench_dir, root)
out = io.StringIO()
assert harness.run(cell, 3, 0.5, False, "cpu", time.perf_counter(), out,
                   io.StringIO()) == 0
"""
    names = _loaded(code)
    assert PORT in names  # the run did drive the program
    assert not names & JAX_NAMES, names & JAX_NAMES


def test_the_reference_loads_nothing_of_the_program():
    names = _loaded("from portbench.reference import stable_diffusion, hed\n"
                    "from portbench import weights, traffic, check, flops\n")
    assert PORT not in names
    assert not names & JAX_NAMES


def test_the_harness_refuses_a_run_that_loaded_jax(tmp_path, monkeypatch):
    """A program that loads a forbidden module makes the run end with no
    result, naming it."""
    import io
    import time
    import types

    from portbench import harness
    from portbench.tests import helpers

    bench, bench_dir, root = helpers.tiny_bench(tmp_path)
    cell = spec.Cell(bench, helpers.TINY_CELL, bench_dir, root)
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(cell, 3, 0.3, False, "cpu", time.perf_counter(), out,
                     err)
    assert rc != 0
    assert out.getvalue().strip() == ""
    assert "jax" in err.getvalue()
