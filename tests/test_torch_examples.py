"""The port's example scripts (``examples/torch/``), on the CPU.

Every script imports the port (with numpy, scipy and torch) and nothing of
JAX or the JAX package; ``readme_examples.py``'s three functions give the
README's values.  ``tensorflow`` is imported inside the TF bridge's
functions only, never when the port is imported.
"""

import ast
import importlib.util
import math
import pathlib

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples" / "torch"
CPU = torch.device("cpu")


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _top(name):
    return name.split(".")[0]


def test_examples_exist_for_every_jax_example():
    jax_names = {p.name for p in (ROOT / "examples").glob("*.py")}
    assert {p.name for p in EXAMPLES.glob("*.py")} == jax_names
    assert len(jax_names) == 20


@pytest.mark.parametrize("script", sorted(p.name for p in EXAMPLES.glob("*.py")))
def test_example_imports_the_port_only(script):
    tree = ast.parse((EXAMPLES / script).read_text())
    tops = {_top(m) for m in _imports(tree)}
    assert "contractn_tpu_torch" in tops, script
    assert not tops & {"jax", "jaxlib", "contractn_tpu", "tensorflow"}, (script, tops)
    assert tops <= {"contractn_tpu_torch", "numpy", "scipy", "torch", "argparse",
                    "itertools", "math", "socket", "time"}, (script, tops)


def test_tensorflow_is_imported_only_inside_the_bridge():
    seen = []
    for path in sorted((ROOT / "contractn_tpu_torch").rglob("*.py")):
        tree = ast.parse(path.read_text())
        for node in tree.body:  # module level
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                         else [node.module or ""])
                assert not any(_top(n) == "tensorflow" for n in names), path
        if any(_top(m or "") == "tensorflow" for m in _imports(tree)):
            seen.append(path.relative_to(ROOT).as_posix())
    assert seen == ["contractn_tpu_torch/compiler/interop.py"]


def _readme():
    spec = importlib.util.spec_from_file_location(
        "readme_examples", EXAMPLES / "readme_examples.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_readme_examples_give_the_readme_values():
    ex = _readme()
    out = ex.copy_tensor_example(CPU)
    np.testing.assert_allclose(out.numpy(), [1.0, 0.36603234], rtol=1e-8)
    np.testing.assert_allclose(out.numpy(), [1.0, 0.99 ** 100], rtol=1e-12)
    cp, tucker = ex.einsum_string_example()
    assert cp.einsum_str == "ac,ad,ae->cde"
    assert tucker.einsum_str == "abc,ae,bf,cg->efg"
    plain, mant, log_scale = ex.stable_contraction_example(CPU)
    assert bool(torch.isinf(plain).all())
    np.testing.assert_allclose(mant.numpy(), [1.0, 1.0, 1.0], rtol=1e-12)
    assert abs(float(log_scale) - 1098.6122886681) < 1e-9
    assert abs(float(log_scale) - 1000 * math.log(3.0)) < 1e-9


def test_readme_cp_tucker_values_on_random_factors():
    import contractn_tpu as jct

    ex = _readme()
    mats = [np.random.default_rng(i).standard_normal((4, 10)) for i in range(3)]
    cp, tucker = ex.einsum_string_example(mats)
    hub = np.ones((4, 4, 4))
    want_cp = np.einsum("ac,ad,ae->cde", *mats)
    want_tucker = np.einsum("abc,ae,bf,cg->efg", hub, *mats)
    np.testing.assert_allclose(cp.contract(device=CPU).numpy(), want_cp, rtol=1e-12)
    np.testing.assert_allclose(tucker.contract(device=CPU).numpy(), want_tucker, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(jct.contract("abc,ae,bf,cg->efg", hub, *mats)),
                               tucker.contract(device=CPU).numpy(), rtol=1e-10)
