"""The comparison that decides ``correct``.

What is judged is what the window's last step left behind: the last
search step's solution (every active pair's counts and neighbor sets, or
every query's sums) and the positions and user arrays as the program's
z-sort wrote them.  The reference (``reference.py``) works everything out
again from the inputs that the benchmark made from the seed:

- ``rows_mismatch``: each row's particle is named by its id, a user array
  the z-sort carries; the ids must be a permutation, and every row of the
  positions and of each user array must equal that particle's start
  values moved ``moves`` times by ``reference.advance``;
- ``zsort_disorder``: rows of a set whose Morton key, at the positions of
  the last z-sort, is below the row before's (limit 0);
- ``nbr_mismatch``: queries whose count differs plus neighbor pairs found
  on one side only, every active pair, every query (limit 0);
- ``sum_rel_err``: the largest gap between a query's sum and the float64
  reference, over the sum of the terms' magnitudes (limit in the mix);
- ``ref_pairs``: the pairs the reference found, at least 1.

``control_outputs`` is the reference computed in bfloat16 and put in the
program's place, the control that has to come out as not correct.
"""

from __future__ import annotations

import torch

from . import reference as ref
from . import roofline
from .cells import active_pairs

CONTROL_DTYPE = torch.bfloat16


def program_outputs(loop) -> dict:
    """What the window's last step left: the state arrays and, from the
    last solution, each pair's counts and sorted neighbor keys, or each
    set's sums."""
    from treensearch_tpu_torch.ops.fastpath import materialize_nbrs
    sol = loop.search.out
    pairs = {}
    for name, pair in sol.get("pairs", {}).items():
        counts = pair["counts"].long()
        rows = materialize_nbrs(dict(pair))
        live = torch.arange(rows.shape[1], device=rows.device)[None, :] \
            < counts[:, None]
        q = torch.arange(rows.shape[0], device=rows.device)[:, None] \
            .expand_as(rows)
        keys = (q[live] << 32) | rows[live].long()
        del rows, live, q
        pairs[name] = (counts, torch.sort(keys).values)
    sums = {k: v.clone() for k, v in sol.get("reduce", {}).items()}
    return {"points": loop.inputs.points, "user": loop.inputs.user,
            "pairs": pairs, "reduce": sums}


def _perms(inputs, user: list) -> tuple:
    """(each set's rows as start indices, rows of sets whose ids are not a
    permutation); without user arrays the rows never moved."""
    perms, bad = [], 0
    for i, n in enumerate(inputs.sizes):
        arange = torch.arange(n, device=inputs.points.device)
        perm = arange
        if user:
            ids = inputs.of_set(user[1], i).long()
            if torch.equal(torch.sort(ids).values, arange):
                perm = ids
            else:
                bad += n
        perms.append(perm)
    return perms, bad


def _positions(inputs, start, perms: list, steps: int) -> list:
    """Each set's start positions in the rows' order, moved ``steps``
    times."""
    out = []
    for i, perm in enumerate(perms):
        x = inputs.of_set(start["points"], i)[perm]
        if start["velocity"] is not None:
            x = ref.advance(x, inputs.of_set(start["velocity"], i)[perm],
                            steps)
        out.append(x)
    return out


def _disorder(x_z: list) -> int:
    """Rows whose Morton key is below the row before's, over all sets."""
    lo, hi = ref.box_of(x_z)
    bad = 0
    for x in x_z:
        keys = ref.morton_keys(x, lo, hi)
        bad += int((keys[1:] < keys[:-1]).sum())
    return bad


def _state(inputs, start, outputs, moves, zsort_moves) -> tuple:
    """(rows_mismatch, zsort_disorder or None, reference positions per
    set): the state arrays against their reconstruction."""
    perms, mismatch = _perms(inputs, outputs["user"])
    x_ref = _positions(inputs, start, perms, moves)
    for i, n in enumerate(inputs.sizes):
        got = inputs.of_set(outputs["points"], i)
        mismatch += int((got != x_ref[i]).any(dim=1).sum())
        for flat, flat0 in zip(outputs["user"], start["user"]):
            got = inputs.of_set(flat, i).reshape(n, -1)
            want = inputs.of_set(flat0, i)[perms[i]].reshape(n, -1)
            mismatch += int((got != want).any(dim=1).sum())
    disorder = None
    if zsort_moves is not None:
        disorder = _disorder(_positions(inputs, start, perms, zsort_moves))
    return mismatch, disorder, x_ref


def _pairs_mismatch(got: tuple, want: tuple) -> int:
    (c_got, k_got), (c_want, k_want) = got, want
    bad = int((c_got != c_want).sum())
    if bad or not torch.equal(k_got, k_want):
        bad += int((~torch.isin(k_want, k_got)).sum()) \
            + int((~torch.isin(k_got, k_want)).sum())
    return bad


def reference_sums(cell, inputs, x_ref, dtype=torch.float64,
                   rule_dtype=torch.float32) -> tuple:
    """(per query set ``(sums, magnitudes)``, neighbor pairs) of the mix's
    callback over every active pair."""
    n_out = int(cell.traffic["reduce"]["n_out"])
    out = {}
    hits = 0
    for i, j in active_pairs(cell.config):
        pi = inputs.of_set(inputs.payload, i)
        pj = inputs.of_set(inputs.payload, j)
        s, m, h = ref.pair_sums(cell.callback, n_out, x_ref[i], x_ref[j],
                                cell.config["radius"], i == j, pi, pj,
                                dtype=dtype, rule_dtype=rule_dtype)
        out[i] = (out[i][0] + s, out[i][1] + m) if i in out else (s, m)
        hits += h
    return out, hits


def _check(value, limit, rule: str = "<=") -> dict:
    return {"value": value, "limit": limit, "rule": rule}


def judge(cell, inputs, start, outputs, moves: int, zsort_moves) -> dict:
    """The checks of one run and whether all of them hold."""
    radius = cell.config["radius"]
    mismatch, disorder, x_ref = _state(inputs, start, outputs, moves,
                                       zsort_moves)
    checks = {"rows_mismatch": _check(mismatch, 0)}
    if disorder is not None:
        checks["zsort_disorder"] = _check(disorder, 0)
    ref_pairs = 0
    if cell.traffic.get("reduce"):
        want, ref_pairs = reference_sums(cell, inputs, x_ref)
        worst = 0.0
        for i, n in enumerate(inputs.sizes):
            got = outputs["reduce"][f"s{i}"].double()
            s, m = want.get(i, (torch.zeros_like(got), torch.zeros_like(got)))
            gap = (got - s).abs()
            rel = torch.where(m > 0, gap / torch.where(m > 0, m, 1.0),
                              torch.where(gap > 0, float("inf"), 0.0))
            if n:
                worst = max(worst, float(rel.max()))
        checks["sum_rel_err"] = _check(
            worst, float(cell.traffic["reduce"]["rel_err_limit"]))
    else:
        bad = 0
        for i, j in active_pairs(cell.config):
            want = ref.neighbor_keys(x_ref[i], x_ref[j], radius, i == j)
            ref_pairs += int(want[1].shape[0])
            got = outputs["pairs"].get(f"{i}-{j}")
            bad += _pairs_mismatch(got, want) if got is not None \
                else int(want[1].shape[0]) + inputs.sizes[i]
        checks["nbr_mismatch"] = _check(bad, 0)
    checks["ref_pairs"] = _check(ref_pairs, 1, ">=")
    correct = all(c["value"] <= c["limit"] if c["rule"] == "<="
                  else c["value"] >= c["limit"] for c in checks.values())
    return {"correct": correct, "checks": checks, "ref_pairs": ref_pairs,
            "x_ref": x_ref}


def control_outputs(cell, inputs, start, moves: int, zsort_moves) -> dict:
    """The reference in bfloat16 in the program's place: the last z-sort's
    order by bfloat16 Morton keys, and the neighbor sets or sums of the
    last step under the bfloat16 rule."""
    radius = cell.config["radius"]
    outputs = {"points": inputs.points.clone(),
               "user": [u.clone() for u in inputs.user],
               "pairs": {}, "reduce": {}}
    perms, _ = _perms(inputs, inputs.user)
    x_ref = _positions(inputs, start, perms, moves)
    if zsort_moves is not None:
        # the rows before the last z-sort's order, put in bfloat16 order
        x_z = _positions(inputs, start, perms, zsort_moves)
        lo, hi = ref.box_of(x_z)
        for i in range(len(inputs.sizes)):
            order = torch.sort(ref.morton_keys(x_z[i], lo, hi,
                                               CONTROL_DTYPE),
                               stable=True).indices
            x_ref[i] = x_ref[i][order]
            inputs.of_set(outputs["points"], i).copy_(x_ref[i])
            for flat, flat0 in zip(outputs["user"], start["user"]):
                inputs.of_set(flat, i).copy_(
                    inputs.of_set(flat0, i)[perms[i][order]])
    if cell.traffic.get("reduce"):
        sums, _ = reference_sums(cell, inputs, x_ref, CONTROL_DTYPE,
                                 CONTROL_DTYPE)
        for i, n in enumerate(inputs.sizes):
            outputs["reduce"][f"s{i}"] = sums[i][0].float() if i in sums \
                else torch.zeros((int(cell.traffic["reduce"]["n_out"]), n),
                                 device=inputs.points.device)
    else:
        for i, j in active_pairs(cell.config):
            outputs["pairs"][f"{i}-{j}"] = ref.neighbor_keys(
                x_ref[i], x_ref[j], radius, i == j, CONTROL_DTYPE)
    return outputs


def least_time(cell, verdict: dict) -> dict:
    """``roofline.least_time`` of the last step's inputs."""
    x_ref = verdict["x_ref"]
    act = active_pairs(cell.config)
    tests = roofline.stencil_tests(x_ref, act, cell.config["cell_factor"]
                                   * cell.config["radius"])
    used = sorted({i for i, _ in act} | {j for _, j in act})
    n_points = sum(x_ref[i].shape[0] for i in used)
    reduce = cell.traffic.get("reduce")
    if reduce:
        n_queries = sum(x_ref[i].shape[0] for i in {i for i, _ in act})
        return roofline.least_time(tests, verdict["ref_pairs"], n_points,
                                   n_queries, int(reduce["ops_per_hit"]),
                                   int(reduce["payload_columns"]),
                                   int(reduce["n_out"]))
    n_queries = sum(x_ref[i].shape[0] for i, _ in act)
    return roofline.least_time(tests, verdict["ref_pairs"], n_points,
                               n_queries)
