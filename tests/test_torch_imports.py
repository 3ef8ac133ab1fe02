"""Package rules of the PyTorch port (textgcn_tpu_torch), checked on the CPU:
its modules import neither JAX, the JAX package nor triton, it imports on a
machine without a GPU, and its kernel wrappers never carry a non-CPU tensor
on silently through a plain version."""
import ast
import importlib
import pathlib

import pytest
import torch

PKG = pathlib.Path(__file__).resolve().parent.parent / "textgcn_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "textgcn_tpu", "triton"}


def _modules():
    # _build/ holds build outputs, not package modules
    return sorted(p for p in PKG.rglob("*.py") if "_build" not in p.relative_to(PKG).parts)


def _imported_roots(path):
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    mods = _modules()
    assert len(mods) > 15
    names = {str(p.relative_to(PKG)) for p in mods}
    assert {
        "topics/lda.py", "topics/model.py", "topics/vectorize.py", "topics/word2vec.py",
        "models/sgc.py", "models/appnp.py", "models/sage.py", "models/gin.py",
        "models/gcnii.py", "models/family.py",
        "text/clean.py", "text/stopwords.py", "graph/build_topic.py", "graph/build_textgcn.py",
        "utils/config.py", "utils/logging.py", "utils/profiling.py", "inspect/topics.py",
        "runner.py", "cli.py", "train/checkpoint.py", "parallel/halo.py",
        "parallel/mesh_attention.py",
    } <= names
    bad = {
        str(p.relative_to(PKG)): sorted(set(_imported_roots(p)) & FORBIDDEN)
        for p in mods
    }
    assert not {k: v for k, v in bad.items() if v}


@pytest.mark.parametrize(
    "path", [p for p in _modules()], ids=lambda p: str(p.relative_to(PKG))
)
def test_every_module_imports_without_a_gpu(path):
    rel = path.relative_to(PKG.parent).with_suffix("")
    name = ".".join(rel.parts).removesuffix(".__init__")
    importlib.import_module(name)


def test_cli_train_refuses_to_run_without_a_gpu(monkeypatch):
    from textgcn_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["train", "--dataset", "R8", "--graph", "docword", "--spmm", "hybrid"])
