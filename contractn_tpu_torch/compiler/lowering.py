"""Shape-bucketed lowering of pairwise contraction paths.

Counterpart of ``contractn_tpu/compiler/lowering.py``.  Real paths are
regular: a greedy path over a long chain is one *level* of about n/2
independent pair contractions of one signature followed by one linear
recurrence.  :func:`plan_program` (ported as it is) recognizes those two
shapes in the step stream:

* **batch bucket** — a run of at least ``MIN_BUCKET`` consecutive, mutually
  independent steps with the same canonical ``(step_str, shapes)``
  signature.  It runs as ONE ``torch.einsum`` over the stacked operands plus
  one per-slice rescale (:func:`~..ops.stabilize.stabilize_batched`).
  Operand stacks are built with one ``torch.stack`` when the inputs are
  separate tensors, or taken whole or by one ``index_select`` when they are
  slices of an earlier bucket's output.
* **scan bucket** — a run of at least ``MIN_BUCKET`` consecutive steps that
  each contract the previous step's output (the carry) with a fresh operand
  of one shape.  It runs as one Python loop over a pre-stacked operand
  tensor: one einsum and one rescale a step, no per-step list work.

Everything else stays a per-step einsum.  Every intermediate is rescaled
exactly once, in the same order as the per-step loop, so values match the
sequential ``backend="numpy"`` oracle to float tolerance.  On the card a
batch bucket turns hundreds of small launches into a handful.
"""

import torch

from ..ops.stabilize import stabilize, stabilize_batched
from ..symbols import get_symbol
from ..utils.device import real_dtype
from ..utils.errors import TNError

MIN_BUCKET = 8

_ASCII = frozenset("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ,->")


def _canon(step_str, swap=False):
    """Remap a 2-term step string onto canonical symbols in first-appearance
    order (the unbounded symbol table of :func:`~..symbols.get_symbol`, so
    steps with more than 52 distinct indices canonicalize instead of
    crashing), optionally swapping the two input terms first."""
    lhs, out = step_str.split("->")
    terms = lhs.split(",")
    if swap:
        terms = terms[::-1]
    mapping = {}
    res = []
    for ch in ",".join(terms) + "->" + out:
        if ch in ",->":
            res.append(ch)
            continue
        if ch not in mapping:
            mapping[ch] = get_symbol(len(mapping))
        res.append(mapping[ch])
    return "".join(res)


def _step_out_shape(step_str, in_shapes):
    dims = {}
    lhs, out = step_str.split("->")
    for term, shape in zip(lhs.split(","), in_shapes):
        for s, d in zip(term, shape):
            dims[s] = d
    return tuple(dims[s] for s in out)


def _classify(steps, n_operands, shapes):
    """Simulate the pop/append operand list, tagging each step with ids,
    shapes, and its bucketing signature."""
    ops = list(range(n_operands))
    shape_of = {i: tuple(shapes[i]) for i in range(n_operands)}
    nxt = n_operands
    records = []
    for inds, step_str in steps:
        in_ids = [ops.pop(i) for i in inds]
        in_shapes = [shape_of[i] for i in in_ids]
        out_shape = _step_out_shape(step_str, in_shapes)
        out_id = nxt
        nxt += 1
        shape_of[out_id] = out_shape
        ops.append(out_id)
        rec = {
            "in_ids": in_ids,
            "in_shapes": in_shapes,
            "out_id": out_id,
            "out_shape": out_shape,
            "step_str": step_str,
        }
        if len(in_ids) == 2:
            prev_out = out_id - 1
            if prev_out in in_ids and records:
                carry_pos = in_ids.index(prev_out)
                canon = _canon(step_str, swap=(carry_pos == 1))
                rec["dep_sig"] = (
                    canon,
                    in_shapes[carry_pos],
                    in_shapes[1 - carry_pos],
                )
                rec["carry_pos"] = carry_pos
            rec["indep_sig"] = (_canon(step_str), tuple(in_shapes))
        records.append(rec)
    return records, ops[0] if ops else None


def plan_program(steps, n_operands, shapes):
    """Group the step stream into (single | batch | scan) plan items.

    Returns ``(plan, result_id)`` or ``(None, None)`` when no bucket
    clears ``MIN_BUCKET`` (the caller keeps the plain per-step loop).
    """
    records, result_id = _classify(steps, n_operands, shapes)
    if not records:
        return None, None

    plan = []
    i = 0
    bucketed = False
    while i < len(records):
        rec = records[i]

        # Scan run: maximal chain of dep steps with one signature whose
        # carry shape is preserved (one fixed-shape carry through the loop)
        sig = rec.get("dep_sig")
        if sig is not None and sig[1] == rec["out_shape"]:
            j = i
            while (
                j < len(records)
                and records[j].get("dep_sig") == sig
                and records[j]["out_shape"] == sig[1]
                and records[j]["in_ids"][records[j]["carry_pos"]]
                == records[j]["out_id"] - 1
            ):
                j += 1
            if j - i >= MIN_BUCKET:
                run = records[i:j]
                plan.append({
                    "kind": "scan",
                    "canon": sig[0],
                    "carry_id": run[0]["in_ids"][run[0]["carry_pos"]],
                    "xs_ids": [
                        r["in_ids"][1 - r["carry_pos"]] for r in run
                    ],
                    "out_id": run[-1]["out_id"],
                })
                bucketed = True
                i = j
                continue

        # Batch run: maximal independent steps with one signature
        sig = rec.get("indep_sig")
        if sig is not None:
            j = i
            outs = set()
            while j < len(records) and records[j].get("indep_sig") == sig:
                if any(x in outs for x in records[j]["in_ids"]):
                    break  # consumes an output of this very run
                outs.add(records[j]["out_id"])
                j += 1
            if j - i >= MIN_BUCKET:
                run = records[i:j]
                plan.append({
                    "kind": "batch",
                    "canon": sig[0],
                    "slot_ids": (
                        [r["in_ids"][0] for r in run],
                        [r["in_ids"][1] for r in run],
                    ),
                    "out_ids": [r["out_id"] for r in run],
                })
                bucketed = True
                i = j
                continue

        plan.append({
            "kind": "single",
            "in_ids": rec["in_ids"],
            "step_str": rec["step_str"],
            "out_id": rec["out_id"],
        })
        i += 1

    if not bucketed:
        return None, None
    return plan, result_id


def _batched_str(canon):
    """Prepend a fresh batch index to every term and the output."""
    i = 0
    while get_symbol(i) in canon:
        i += 1
    free = get_symbol(i)
    lhs, out = canon.split("->")
    return ",".join(free + t for t in lhs.split(",")) + "->" + free + out


def _torch_str(eq):
    """``eq`` if ``torch.einsum`` can take it (ASCII letters only)."""
    if not set(eq) <= _ASCII:
        raise TNError(
            "A bucketed contraction step uses more than 52 distinct indices"
        )
    return eq


class BucketedProgram:
    """A plan from :func:`plan_program`, ready to run on torch operands.

    The registry keeps a batch bucket's outputs as slices of its output
    stack, so a later bucket that consumes them takes the stack whole (or
    one ``index_select`` of it) instead of re-stacking slice by slice.
    """

    def __init__(self, plan, result_id):
        self.plan = plan
        self.result_id = result_id
        self._strs = [
            _torch_str(
                _batched_str(item["canon"]) if item["kind"] == "batch"
                else item.get("canon", item.get("step_str"))
            )
            for item in plan
        ]
        self._index = {}  # (device, ids) -> index tensor

    def __len__(self):
        return len(self.plan)

    def run(self, ops):
        """Contract ``ops`` (one common dtype and device); returns
        ``(mantissa, log_scale)``."""
        device = ops[0].device
        log_dtype = real_dtype(ops[0].dtype)
        log_scale = torch.zeros((), dtype=log_dtype, device=device)
        reg = {i: ("arr", t) for i, t in enumerate(ops)}
        stacks = {}

        def mat(entry):
            return (entry[1] if entry[0] == "arr"
                    else stacks[entry[1]][entry[2]])

        def gather(ids):
            ents = [reg.pop(i) for i in ids]
            sids = {e[1] for e in ents if e[0] == "slice"}
            if len(sids) == 1 and all(e[0] == "slice" for e in ents):
                s = stacks[next(iter(sids))]
                idxs = tuple(e[2] for e in ents)
                if idxs == tuple(range(s.shape[0])):
                    return s
                key = (device, idxs)
                if key not in self._index:
                    self._index[key] = torch.tensor(idxs, device=device)
                return s.index_select(0, self._index[key])
            return torch.stack([mat(e) for e in ents])

        for sn, (item, eq) in enumerate(zip(self.plan, self._strs)):
            if item["kind"] == "single":
                tmp = [mat(reg.pop(i)) for i in item["in_ids"]]
                new, log_scale = stabilize(torch.einsum(eq, *tmp), log_scale)
                reg[item["out_id"]] = ("arr", new)
            elif item["kind"] == "batch":
                a = gather(item["slot_ids"][0])
                b = gather(item["slot_ids"][1])
                out = torch.einsum(eq, a, b)
                out, logs = stabilize_batched(
                    out, torch.zeros(out.shape[0], dtype=log_dtype,
                                     device=device), 1
                )
                log_scale = log_scale + logs.sum()
                stacks[sn] = out
                for pos, oid in enumerate(item["out_ids"]):
                    reg[oid] = ("slice", sn, pos)
            else:  # scan
                xs = gather(item["xs_ids"])
                carry = mat(reg.pop(item["carry_id"]))
                lg = torch.zeros((), dtype=log_dtype, device=device)
                for k in range(xs.shape[0]):
                    carry, lg = stabilize(torch.einsum(eq, carry, xs[k]), lg)
                log_scale = log_scale + lg
                reg[item["out_id"]] = ("arr", carry)

        return mat(reg[self.result_id]), log_scale


def lower(steps, n_operands, shapes):
    """A :class:`BucketedProgram` for ``steps``, or None where no bucket
    clears ``MIN_BUCKET``."""
    plan, result_id = plan_program(steps, n_operands, shapes)
    if plan is None:
        return None
    return BucketedProgram(plan, result_id)
