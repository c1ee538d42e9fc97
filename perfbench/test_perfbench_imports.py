"""No module of the benchmark imports JAX or the JAX package, and no module
of its plain references imports the program (``repro_torch``). Top-level
names are compared whole: the port's name begins with the JAX package's."""

import ast

import pytest

import pb_common as pc

FILES = sorted(p for p in pc.HERE.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(pc.HERE)))
def test_no_jax_and_no_program_in_the_references(path):
    names = set(top_level_imports(path))
    assert not names & {"jax", "jaxlib", "flax", "repro"}, path
    if "reference" in path.relative_to(pc.HERE).parts:
        assert "repro_torch" not in names, path


def test_run_prints_no_result_when_jax_is_loaded(monkeypatch, capsys):
    import sys
    import types

    import torch

    import pb_harness

    run = pc.load_module(pc.HERE / "run.py")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(pb_harness, "run_cell",
                        lambda *a, **k: {"checks": {}})
    monkeypatch.setitem(sys.modules, "jax.fake_submodule",
                        types.ModuleType("jax.fake_submodule"))
    argv = ["--workload", pc.benchmark()["workloads"][0]["name"],
            "--seed", "1", "--seconds", "1"]
    assert run.main(argv) == 3
    assert capsys.readouterr().out == ""
    monkeypatch.setattr(pb_harness, "forbidden_modules", lambda: [])
    assert run.main(argv) == 0
    assert capsys.readouterr().out.strip() == '{"checks": {}}'


def test_the_port_is_not_taken_for_the_jax_package():
    import pb_harness
    import repro_torch  # noqa: F401

    found = pb_harness.forbidden_modules()
    assert "repro_torch" not in found
    assert set(found) <= {"jax", "jaxlib", "flax", "repro"}


def test_run_needs_a_card(monkeypatch, capsys):
    import torch

    run = pc.load_module(pc.HERE / "run.py")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--workload", pc.benchmark()["workloads"][0]["name"],
            "--seed", "1", "--seconds", "1"]
    assert run.main(argv) == 2
    assert capsys.readouterr().out == ""
