"""docs/torch/API.md is executable documentation: every ```python block
runs, in order, in one shared namespace, on the CPU (the twin of
``tests/test_docs_api.py`` for the port's page)."""

import os
import re

import torch

DOC = os.path.join(os.path.dirname(__file__), os.pardir, "docs", "torch", "API.md")


def _blocks():
    with open(DOC, encoding="utf-8") as f:
        text = f.read()
    blocks = re.findall(r"```python\n(.*?)```", text, flags=re.DOTALL)
    assert len(blocks) >= 6, "docs/torch/API.md lost its executable examples"
    return blocks


def test_api_md_blocks_execute_in_order(tmp_path, monkeypatch):
    # relative paths and temporary directories a block makes land under
    # pytest's tmp
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    tempfile.tempdir = None  # re-read TMPDIR
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    ns = {}
    try:
        for i, src in enumerate(_blocks()):
            try:
                exec(compile(src, f"{DOC}#block{i + 1}", "exec"), ns)
            except Exception as e:  # pragma: no cover - failure formatting
                raise AssertionError(
                    f"docs/torch/API.md block {i + 1} failed: {e}\n--- block ---\n{src}"
                ) from e
    finally:
        torch.set_num_threads(threads)
        tempfile.tempdir = None  # don't leak the patched default
