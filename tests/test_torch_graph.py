"""Graph layer of the PyTorch port against the JAX package.

The same build sequences go through ``contractn_tpu.TN`` and
``contractn_tpu_torch.TN``; einsum strings must agree byte for byte.  Also
holds the port's import and precision rules (an AST check) and its device
rule (no GPU and no ``device="cpu"`` raises).
"""

import ast
import pathlib

import numpy as np
import opt_einsum
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import contractn_tpu as jtn
import contractn_tpu_torch as ttn
from contractn_tpu_torch.symbols import get_symbol, symbol_index

torch.set_num_threads(1)

PORT = pathlib.Path(__file__).resolve().parents[1] / "contractn_tpu_torch"


def test_symbol_table_matches_opt_einsum():
    for i in list(range(300)) + [55295, 55296, 55297, 60000]:
        assert get_symbol(i) == opt_einsum.get_symbol(i)
        assert symbol_index(get_symbol(i)) == i


def _cp_tucker(pkg):
    cp, tucker = pkg.TN(), pkg.TN()
    cp_hub = cp.add_copy_node(3)
    tucker_hub = tucker.add_dense_node(np.ones((4, 4, 4)))
    for i in range(3):
        mat = np.eye(4, 10)
        cp.connect_nodes(cp_hub, cp.add_dense_node(mat), i, 0)
        tucker.connect_nodes(tucker_hub, tucker.add_dense_node(mat), i, 0)
    return cp, tucker


def test_cp_tucker_strings_byte_identical():
    cp_j, tucker_j = _cp_tucker(jtn)
    cp_t, tucker_t = _cp_tucker(ttn)
    assert cp_t.einsum_str == cp_j.einsum_str == "ac,ad,ae->cde"
    assert tucker_t.einsum_str == tucker_j.einsum_str == "abc,ae,bf,cg->efg"


# A build program: a list of operations applied identically to both packages
_op = st.one_of(
    st.tuples(st.just("dense"), st.integers(1, 3)),
    st.tuples(st.just("copy"), st.integers(2, 3)),
    st.tuples(st.just("connect"), st.integers(0, 99), st.integers(0, 99)),
    st.tuples(st.just("remove"), st.integers(0, 99)),
)


def _run_program(pkg, program):
    tn = pkg.TN()
    dangling = []  # (node, mode) pairs still open, in creation order
    for op in program:
        if op[0] == "dense":
            node = tn.add_dense_node(np.ones((2,) * op[1]))
            dangling += [(node, m) for m in range(op[1])]
        elif op[0] == "copy":
            node = tn.add_copy_node(op[1], dim=2)
            dangling += [(node, m) for m in range(op[1])]
        elif op[0] == "connect" and len(dangling) >= 2:
            a = dangling.pop(op[1] % len(dangling))
            b = dangling.pop(op[2] % len(dangling))
            if a[0] is b[0]:
                continue
            tn.connect_nodes(a[0], b[0], a[1], b[1])
        elif op[0] == "remove":
            bonds = [e for e in tn.edges() if not e.dangler]
            if bonds:
                edge = bonds[op[1] % len(bonds)]
                tn.remove_edge(edge)
                ends = edge.nodes
                dangling += [(n, i) for n in ends for i, en in enumerate(n.edge_names)
                             if tn._edges[en].dangler and (n, i) not in dangling]
    return tn


@settings(max_examples=25, deadline=None)
@given(st.lists(_op, min_size=1, max_size=14))
def test_random_builds_give_identical_strings(program):
    assert _run_program(ttn, program).einsum_str == \
        _run_program(jtn, program).einsum_str


def test_merge_nodes_matches_jax():
    rng = np.random.default_rng(0)
    a, b, c = (rng.standard_normal(s) for s in ((3, 4, 5), (5, 4, 2), (2, 3)))
    results = []
    for pkg in (jtn, ttn):
        tn = pkg.TN()
        na, nb, nc = (tn.add_dense_node(t) for t in (a, b, c))
        tn.connect_nodes(na, nb, 2, 0)
        tn.connect_nodes(na, nb, 1, 1)
        tn.connect_nodes(nb, nc, 2, 0)
        merged = tn.merge_nodes(na, nb)
        results.append((tn.einsum_str, np.asarray(merged.tensor)))
    assert results[0][0] == results[1][0]
    np.testing.assert_allclose(results[1][1], results[0][1], rtol=1e-12)


def test_merge_keeps_torch_tensors_on_their_device():
    tn = ttn.TN()
    na = tn.add_dense_node(torch.ones(2, 3, dtype=torch.float64))
    nb = tn.add_dense_node(np.ones((3, 4)))
    tn.connect_nodes(na, nb, 1, 0)
    merged = tn.merge_nodes(na, nb)
    assert isinstance(merged.tensor, torch.Tensor)
    assert torch.allclose(merged.tensor, torch.full((2, 4), 3.0, dtype=torch.float64))


def test_copy_is_independent_and_identical():
    _, tucker = _cp_tucker(ttn)
    dup = tucker.copy()
    assert dup.einsum_str == tucker.einsum_str
    dup.remove_edge(next(e for e in dup.edges() if not e.dangler))
    assert dup.einsum_str != tucker.einsum_str
    assert tucker.einsum_str == "abc,ae,bf,cg->efg"


def test_graph_errors_match():
    for pkg in (jtn, ttn):
        tn = pkg.TN()
        a = tn.add_dense_node(np.ones((2, 3)))
        b = tn.add_dense_node(np.ones((4,)))
        with pytest.raises(pkg.TNError):
            tn.connect_nodes(a, b, 1, 0)
        tn.connect_nodes(a, tn.add_dense_node(np.ones((3,))), 1, 0)
        with pytest.raises(pkg.TNError):
            tn.connect_nodes(a, b, 1, 0)  # mode already bonded


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _port_files():
    """Every Python file of the port, its smoke script and its scripts."""
    return sorted(PORT.rglob("*.py")) + [
        PORT.parent / "chip_smoke.py",
        PORT.parent / "scripts" / "profile_training_cuda.py",
        PORT.parent / "scripts" / "profile_chains_cuda.py",
        PORT.parent / "scripts" / "profile_parallel_cuda.py",
        PORT.parent / "scripts" / "born_adam_divergence.py",
        PORT.parent / "scripts" / "time_chemistry_mpo.py",
    ]


def test_scans_cover_every_ported_module():
    scanned = {p.relative_to(PORT).as_posix() for p in _port_files()
               if PORT in p.parents}
    for module in ("compiler/paths.py", "ops/krylov.py", "models/mpo.py",
                   "models/dmrg.py", "models/autompo.py", "models/ensemble.py",
                   "models/tdvp.py", "models/dmrgx.py", "models/dmrg3s.py",
                   "models/itebd.py", "models/circuits.py", "models/linsolve.py",
                   "models/chebyshev.py", "models/excitations.py",
                   "ops/optim.py",
                   *(f"models/{m}.py" for m in SLICES),
                   *(f"parallel/{m}.py" for m in SLICE12)):
        assert module in scanned, module
    assert all(p.is_file() for p in _port_files())


# the modules of Queue A §8.4-§8.7, at the JAX package's relative paths
SLICE7 = ("fermions", "fermions2d", "spin2d", "u1", "hubbard", "quantics", "tci",
          "circuit_compile", "metts", "trajectories", "mpo_evolution", "lindblad",
          "dynamical", "operator_dynamics", "noisy")
# Queue A §8.8 and §9.0-§9.2
SLICE8 = ("gaussians", "chemistry", "vumps", "umps", "excitations", "vumps_cell",
          "excitations_cell", "u1_vumps", "u1_vumps_cell")
# Queue A §9.3-§9.4, §10.1 and the head of §10.2
SLICE9 = ("thermal", "lindblad_infinite", "ibc", "ctmrg", "trg", "hotrg",
          "factorize", "mera", "ipeps")
# Queue A §10.2-§10.4: unit cells, fermionic PEPS, PEPS sampling
SLICE10 = ("ctmrg_cell", "ipeps_cell", "full_update", "thermal2d", "variational",
           "fswap", "fipeps", "fipeps_spin", "peps_sample", "peps_born", "peps_vmc")


# Queue A §10.6 and §10.5: the 3D family and tree tensor networks
SLICE11 = ("hotrg3d", "ipeps3d", "thermal3d", "ttn", "ttn_tdvp")


SLICES = SLICE7 + SLICE8 + SLICE9 + SLICE10 + SLICE11

# Queue A §11: the parallel layer on torch.distributed, at the JAX package's
# paths (plus the port's collectives and its multi-process dry run)
SLICE12 = ("mesh", "_collectives", "sharded", "tp", "training", "pipeline", "generative",
           "ensembles", "tp_dmrg", "rs_dmrg", "spectra", "dryrun")


def test_models_export_the_jax_names_of_each_ported_module():
    """From each of these modules, ``models/__init__`` exports exactly the
    names the JAX package's ``models/__init__`` exports from it."""
    def exported(pkg_dir):
        tree = ast.parse((pkg_dir / "models" / "__init__.py").read_text())
        out = {}
        for node in tree.body:
            if isinstance(node, ast.ImportFrom) and node.module in SLICES:
                out.setdefault(node.module, set()).update(
                    a.asname or a.name for a in node.names)
        return out

    want = exported(PORT.parent / "contractn_tpu")
    got = exported(PORT)
    assert set(want) == set(SLICES) and got == want
    import contractn_tpu_torch.models as models

    for names in got.values():
        assert names <= set(models.__all__)
        assert all(hasattr(models, n) for n in names)


# Names the port exports beyond the JAX package's, by subpackage (``parallel``
# also exports the log-MSE ``loss_fn`` its training steps share), and the
# subpackages whose JAX names are not all ported: ``utils`` holds a jaxlib
# workaround with no counterpart by design.  Every subpackage is ported (the
# parallel layer last, Queue A §11).
PORT_ONLY = {"models": {"boundary_contract", "rayleigh", "truncate_safe"},
             "parallel": {"loss_fn"}}
NO_COUNTERPART = {"utils": {"CompileGuard", "cache_guard"}}
PENDING = ()


@pytest.mark.parametrize("sub", ["models", "ops", "compiler", "utils", "parallel"])
def test_subpackage_exports_cover_the_jax_package(sub):
    """Each subpackage exports every name its JAX counterpart does, except the
    recorded departures; ``models`` exports exactly the JAX names plus its
    recorded extras."""
    from importlib import import_module

    want = set(import_module(f"contractn_tpu.{sub}").__all__)
    got = set(import_module(f"contractn_tpu_torch.{sub}").__all__)
    if sub in PENDING:  # once ported, it leaves PENDING
        assert not want <= got
        return
    assert want - got == NO_COUNTERPART.get(sub, set())
    if sub in PORT_ONLY:
        assert got - want == PORT_ONLY[sub]


def test_port_imports_no_jax_and_never_enables_tf32():
    files = _port_files()
    bad = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for mod in _imports(tree):
            root = mod.split(".")[0]
            if root in ("jax", "jaxlib", "contractn_tpu"):
                bad.append(f"{path.name}: imports {mod}")
        for node in ast.walk(tree):
            # torch.backends.*.allow_tf32 = <anything but False>
            if isinstance(node, ast.Assign):
                value = node.value
                is_false = isinstance(value, ast.Constant) and value.value is False
                for target in node.targets:
                    if isinstance(target, ast.Attribute) and \
                            target.attr == "allow_tf32" and not is_false:
                        bad.append(f"{path.name}:{node.lineno}: allow_tf32 not False")
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "set_float32_matmul_precision":
                arg = node.args[0] if node.args else None
                if not (isinstance(arg, ast.Constant) and arg.value == "highest"):
                    bad.append(f"{path.name}:{node.lineno}: matmul precision lowered")
    assert not bad, bad


def test_port_needs_no_opt_einsum_or_networkx():
    """opt_einsum is imported nowhere in the port, networkx only inside the
    method that exports to it (neither is installed beside the card)."""
    files = _port_files()
    bad = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for mod in _imports(tree):
            if mod.split(".")[0] == "opt_einsum":
                bad.append(f"{path.name}: imports {mod}")
        for mod in _import_time_imports(tree):
            if mod.split(".")[0] == "networkx":
                bad.append(f"{path.name}: imports {mod} at import time")
    assert not bad, bad


def _import_time_imports(node):
    """Imports that run when the module is imported: all but those inside
    function bodies."""
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
            continue
        if isinstance(child, ast.Import):
            yield from (alias.name for alias in child.names)
        elif isinstance(child, ast.ImportFrom) and child.level == 0:
            yield child.module
        else:
            yield from _import_time_imports(child)


def test_top_level_api_matches_jax():
    assert set(ttn.__all__) == set(jtn.__all__)
    for name in ttn.__all__:
        assert hasattr(ttn, name), name


def test_entry_points_raise_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ttn.TNError, match="device='cpu'"):
        ttn.contract("ab,b->a", np.ones((2, 2)), np.ones(2))
    _, tucker = _cp_tucker(ttn)
    with pytest.raises(ttn.TNError, match="device='cpu'"):
        tucker.contract()
    from contractn_tpu_torch.models import MPS, tfim_mpo

    with pytest.raises(ttn.TNError, match="device='cpu'"):
        MPS.random(4, 2, 3)
    with pytest.raises(ttn.TNError, match="device='cpu'"):
        tfim_mpo(4)
    from contractn_tpu_torch.models import hubbard_vumps, transfer_spectrum
    from contractn_tpu_torch.models.chemistry import chemistry_mpo

    with pytest.raises(ttn.TNError, match="device='cpu'"):
        hubbard_vumps(4.0)
    with pytest.raises(ttn.TNError, match="device='cpu'"):
        transfer_spectrum(np.ones((2, 1, 1)))
    with pytest.raises(ttn.TNError, match="device='cpu'"):
        chemistry_mpo(np.eye(2), np.zeros((2, 2, 2, 2)) + 0.1)
    # the CPU stays available on request, and torch operands keep theirs
    out = ttn.contract("ab,b->a", np.ones((2, 2)), np.ones(2), device="cpu")
    assert out.device.type == "cpu"
    out = ttn.contract("ab,b->a", torch.ones(2, 2), torch.ones(2))
    assert out.device.type == "cpu"
