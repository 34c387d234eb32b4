"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from .conftest import BASE, ROOT, small_copy

# top-level names compared whole: the port's name begins with the JAX
# package's
CHECK = """
import json, sys
tops = sorted({m.split('.')[0] for m in list(sys.modules)})
print(json.dumps(tops))
"""


def _tops(code: str, cwd=ROOT) -> set[str]:
    p = subprocess.run([sys.executable, "-c", code + CHECK], cwd=cwd,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_a_run_of_every_entry_loads_no_jax(tmp_path):
    """Every module of the benchmark, and a traced run of a small cell of
    each entry, in one process."""
    code = f"""
import sys, time
sys.path.insert(0, {str(ROOT)!r})
sys.path.insert(0, {str(tmp_path / 'small')!r})
from portbench.tests.conftest import small_copy
from pathlib import Path
base = small_copy(Path({str(tmp_path / 'small')!r}))
from portbench import harness, control, readers, run as _run_module
from portbench.loader import Bench
b = Bench(base)
for folder, load in (('entries', b.entry), ('e2e_metrics', b.e2e_metric),
                     ('layer_metrics', b.layer_metric), ('work', b.work),
                     ('sends', b.sends), ('loops', b.loop),
                     ('generators', b.generator)):
    for f in (base / folder).glob('*.py'):
        load(f.stem)
for cell in ('small.encode', 'small.decode', 'smallframe.encode',
             'smallx4.encode'):
    for traced in (False, True):
        r = harness.run(b, cell, 7, 0.2, traced, time.perf_counter(),
                        device='cpu', log=lambda *a, **k: None)
        assert r['correct'], (cell, r)
assert not harness.forbidden_modules()
"""
    (tmp_path / "small").mkdir()
    tops = _tops(code)
    assert "tinyimgcodec_tpu_torch" in tops and "portbench" in tops
    assert not tops & {"jax", "jaxlib", "flax", "tinyimgcodec_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    tops = _tops(f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
                 "import portbench.reference.codec, portbench.traffic; "
                 "from portbench.loader import Bench; b = Bench(); "
                 "[b.generator(n) for n in ('synthetic_corpus', "
                 "'seeded_image')]")
    assert "portbench" in tops
    assert not tops & {"tinyimgcodec_tpu_torch", "tinyimgcodec_tpu", "jax",
                       "torch"}


def test_the_reference_sources_import_only_numpy_scipy_and_themselves():
    for path in (BASE / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    continue
                names = [node.module]
            else:
                continue
            for n in names:
                assert n.split(".")[0] in {"numpy", "scipy", "struct", "os",
                                           "concurrent", "__future__"}, (
                    path, n)


def test_the_forbidden_check_compares_whole_names(monkeypatch):
    from portbench import harness

    monkeypatch.setitem(sys.modules, "tinyimgcodec_tpu_torch_x", object())
    assert "tinyimgcodec_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tinyimgcodec_tpu.api", object())
    assert harness.forbidden_modules() == ["tinyimgcodec_tpu"]


def test_a_reader_that_loads_jax_ends_the_run_without_a_result(tmp_path):
    """The check runs last, once the readers, the reference and the
    comparison have run: a per-layer reader that imports a (stub) ``jax``
    leaves the run with no result."""
    base = small_copy(tmp_path / "b")
    stub = tmp_path / "stub" / "jax"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("")
    (base / "layer_metrics" / "jax_share.encode.py").write_text(
        "import jax  # noqa: F401\n\n\ndef read(record):\n    return 1.0\n")
    spec_path = tmp_path / "b" / "BENCHMARK.json"
    spec = json.loads(spec_path.read_text())
    spec["per_layer"].append({
        "name": "jax_share.encode", "unit": "%", "better": "lower",
        "source": "host_clock", "layer": "device", "moves": "encode_mp_s",
        "workloads": ["small.encode"]})
    spec_path.write_text(json.dumps(spec))
    code = f"""
import sys, time
sys.path.insert(0, {str(ROOT)!r})
sys.path.insert(0, {str(tmp_path / 'stub')!r})
from portbench import harness
from portbench.loader import Bench
r = harness.run(Bench({str(base)!r}), 'small.encode', 11, 0.2, True,
                time.perf_counter(), device='cpu')
print('RESULT', r)
"""
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "RESULT None" in p.stdout
    assert "forbidden modules loaded: jax" in p.stderr


def test_a_run_with_no_result_exits_3_and_prints_nothing(monkeypatch,
                                                          capsys):
    import torch

    from portbench import harness

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(harness, "run", lambda *a, **k: None)
    rc = harness.main(["--workload", "corpus512.encode", "--seed", "1",
                       "--seconds", "1"], 0.0)
    assert rc == 3
    assert capsys.readouterr().out == ""
