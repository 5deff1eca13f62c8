"""The port's examples (``examples/torch_*.py``) run end to end on the
CPU, in this process, with ``--device cpu`` (every kernel its plain
version), and import nothing of the reference package or its framework.
"""
import ast
import importlib.util
import pathlib
import re

import pytest

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"
NAMES = ("torch_quickstart", "torch_serve_lm", "torch_sparse_gemm_demo",
         "torch_train_lm")


def load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def imported_roots(name: str) -> set:
    tree = ast.parse((EXAMPLES / f"{name}.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add((node.module or "").split(".")[0])
    return roots


@pytest.mark.parametrize("name", NAMES)
def test_example_imports_only_the_port(name):
    roots = imported_roots(name)
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}


@pytest.mark.parametrize("name,argv,ok", [
    ("torch_serve_lm", [], "serve_lm OK"),
    ("torch_sparse_gemm_demo", [], "sparse_gemm_demo OK"),
    ("torch_sparse_gemm_demo", ["0.3"], "sparse_gemm_demo OK"),
])
def test_example_runs_on_the_cpu(name, argv, ok, capsys):
    assert load(name).main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.rstrip().splitlines()[-1] == ok
    assert "TPU" not in out and "v5e" not in out


def test_quickstart_skips_tiles_and_trains(capsys):
    assert load("torch_quickstart").main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.rstrip().splitlines()[-1] == "quickstart OK"
    assert "TPU" not in out and "v5e" not in out
    assert "plan: gate=lhs" in out
    skipped, total = map(int, re.search(
        r"\((\d+) of (\d+) x tiles skipped\)", out).groups())
    assert 0 < skipped < total
    first, last = map(float, re.search(
        r"loss: ([\d.]+) -> ([\d.]+)", out).groups())
    assert last < first


def test_train_lm_trains_checkpoints_and_resumes(tmp_path, capsys):
    example = load("torch_train_lm")
    argv = ["--fast", "--steps", "3", "--ckpt-dir", str(tmp_path),
            "--device", "cpu"]
    rc = example.main(argv)
    out = capsys.readouterr().out
    steps = re.findall(r"^step\s+(\d+) loss\s+([\d.]+)", out, re.M)
    assert [int(s) for s, _ in steps] == [0, 1, 2]
    first, last = map(float, re.search(r"^loss ([\d.]+) -> ([\d.]+)$", out,
                                       re.M).groups())
    assert (first, last) == (round(float(steps[0][1]), 3),
                             round(float(steps[-1][1]), 3))
    # The reference's rule: exit 0 only when the loss fell (3 steps of a
    # 10-step warmup need not).
    assert rc == (0 if last < first else 1)
    assert any(tmp_path.iterdir())  # checkpoints written
    # A second run with the same flags resumes past the target and ends.
    assert example.main(argv) == 0
    assert capsys.readouterr().out.rstrip().endswith(
        "resumed past target step; nothing to train")


def test_train_lm_defaults_to_its_own_checkpoint_dir(monkeypatch, tmp_path):
    example = load("torch_train_lm")
    seen = {}

    def fake_main(flags):
        seen["dir"] = flags[flags.index("--ckpt-dir") + 1]
        return {"history": []}

    monkeypatch.setattr(example.train_launch, "main", fake_main)
    monkeypatch.setattr(example.tempfile, "gettempdir", lambda: str(tmp_path))
    assert example.main(["--fast", "--steps", "7", "--device", "cpu"]) == 0
    assert seen["dir"] == str(tmp_path / "repro_torch_train_lm_fast_7")
