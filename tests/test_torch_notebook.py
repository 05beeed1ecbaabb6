"""The port's notebook, examples/torch/ctn_torch_examples.ipynb: valid
nbformat-4 JSON whose code cells are the generator's
(scripts/make_torch_notebook.py) and import only the port of this
repository, with outputs recorded on the card the first cell names."""

import ast
import importlib.util
import json
import re
from pathlib import Path

import nbformat

ROOT = Path(__file__).resolve().parents[1]
NOTEBOOK = ROOT / "examples" / "torch" / "ctn_torch_examples.ipynb"
# modules a cell may import: the port, the libraries it runs on, the stdlib
ALLOWED = {"contractn_tpu_torch", "math", "numpy", "subprocess", "time", "torch"}


def _generator():
    spec = importlib.util.spec_from_file_location(
        "make_torch_notebook", ROOT / "scripts" / "make_torch_notebook.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _notebook():
    return json.loads(NOTEBOOK.read_text())


def _imports(src):
    names = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module.split(".")[0])
    return names


def test_notebook_is_valid_nbformat_4():
    nb = _notebook()
    assert nb["nbformat"] == 4
    nbformat.validate(nbformat.from_dict(nb))


def test_notebook_cells_are_the_generators():
    cells = [(c["cell_type"], "".join(c["source"])) for c in _notebook()["cells"]]
    assert cells == [tuple(cell) for cell in _generator().CELLS_SRC]


def test_notebook_imports_only_the_port():
    for cell in _notebook()["cells"]:
        if cell["cell_type"] == "code":
            names = _imports("".join(cell["source"]))
            assert names <= ALLOWED, names - ALLOWED
            assert not names & {"jax", "jaxlib", "contractn_tpu"}


def test_notebook_outputs_name_the_card_and_the_kernel_path():
    code = [c for c in _notebook()["cells"] if c["cell_type"] == "code"]
    assert all(c["outputs"] for c in code)
    first = "".join(code[0]["outputs"][0]["text"])
    assert re.match(r"NVIDIA .+, \d+(\.\d+)? W\n", first), first
    last = "".join(code[-1]["outputs"][0]["text"])
    assert "path: cluster" in last and "'cluster': 1" in last, last
