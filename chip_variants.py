#!/usr/bin/env python3
"""The design choices of the pairs kernels K2a and K3, measured on the card.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_variants.py

At BASELINE config 1 (``chip_smoke.py``'s 1M points, r = 0.02, cell 1.15
r, seed 0; a settled engine's structures) it prints, each as one JSON
line:

- ``hit_words``: from the plain version's hit masks, the share of (warp,
  candidate) steps in which at least one of the warp's 32 query lanes
  hits (what a hit branch inside the test loop costs), and, over the
  stream's 32-candidate words, the mean of the busiest lane's hits per
  warp and word (what the word drain costs) and the share of words and of
  4-candidate groups with a hit;
- ``k2a``: ``csrc/pairs.cu`` as committed and built again with one
  change each (K2b's branch per 4 tests instead of the word drain; the
  rows' -1 tails filled by a loop per lane, as the first K2a filled them,
  instead of line by line across the warp), each equal to the plain version
  (counts, and rows slot for slot), their registers, shared memory and
  spills, and their times in four rounds of turns (CUDA events, median
  of 7 runs of 10 calls);
- ``k3``: ``csrc/reduce.cu`` for each of ``chip_smoke.py``'s five
  callbacks at ``__launch_bounds__`` 8 (as committed), 10 and 12 resident
  blocks: registers and spills; the density's and ``density4_fn``'s
  sums within ``REDUCE_RTOL`` of the plain version and their times in
  turns.

Every variant is the committed source with one substitution, built by
``nvcc`` into ``build/``; the script fails if a substitution does not
apply, a build fails or a variant disagrees with the plain version.  It
imports nothing of JAX and exits non-zero without CUDA.
"""

from __future__ import annotations

import ctypes
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROUNDS = 4   # rounds of turns over the variants, the order reversed in odd

# K2a's word drain as committed, and K2b's branch per UNROLL tests
DRAIN = """      const int mw = (m + WORD - 1) / WORD * WORD;
      for (int j0 = 0; j0 < mw; j0 += WORD) {
        unsigned hits = 0u;
#pragma unroll
        for (int u = 0; u < WORD; ++u) {
          const float4 cg = g[j0 + u];
          if (d2_rn(cg.x, cg.y, cg.z, qx, qy, qz) <= qr2) hits |= 1u << u;
        }
        for (; hits; hits &= hits - 1) append(buf, j0 + __ffs(hits) - 1);
      }
"""
BRANCH = """      const int mp = (m + UNROLL - 1) / UNROLL * UNROLL;
      for (int j0 = 0; j0 < mp; j0 += UNROLL) {
        bool hit[UNROLL];
        bool any = false;
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const float4 cg = g[j0 + u];
          hit[u] = d2_rn(cg.x, cg.y, cg.z, qx, qy, qz) <= qr2;
          any = any || hit[u];
        }
        if (any) {
#pragma unroll
          for (int u = 0; u < UNROLL; ++u)
            if (hit[u]) append(buf, j0 + u);
        }
      }
"""
# K2a's -1 tails, line by line across the warp, and a loop per lane
FILL = """    int k0 = min(count, k8_1);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      k0 = min(k0, __shfl_xor_sync(FULL, k0, off));
    for (int k = k0; k < k8_1; ++k)
      if (k >= count) row[(size_t)k * TILE] = -1;
"""
FILL_PER_LANE = """    for (int k = count; k < k8_1; ++k) row[(size_t)k * TILE] = -1;
"""
K3_BOUNDS = "__launch_bounds__(TILE, 8)"


def substitute(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"substitution does not apply: {old[:60]!r}")
    return text.replace(old, new)


def hit_words(a, q) -> dict:
    """The hit statistics of K2a's inputs, from the plain version's hit
    masks, chunk of tiles by chunk of tiles."""
    import torch
    from treensearch_tpu_torch.ops import pairs as P
    n = {"steps": 0, "steps_any": 0, "words": 0, "words_any": 0,
         "busiest": 0, "groups": 0, "groups_any": 0, "hits": 0}
    for ch in P._plain_chunks(a.desc, q, a.recs_t, a.n_win, a.tiles_cap,
                              a.r2, False):
        nt = ch.t1 - ch.t0
        n["hits"] += int(ch.hit.sum())
        n["steps"] += 4 * int(ch.ok.sum())
        n["steps_any"] += int((ch.hit.view(nt, 4, 32, -1).any(dim=2)
                               & ch.ok[:, None, :]).sum())
        # the stream index of each window slot, and its word and group
        k = torch.cumsum(ch.ok.int(), dim=1) - 1
        total = ch.ok.sum(dim=1)
        for size, key in ((32, "words"), (4, "groups")):
            n_max = int((total.max() + size - 1) // size)
            idx = torch.where(ch.ok, k // size, n_max).long()
            per = torch.zeros((nt, 128, n_max + 1), dtype=torch.int32,
                              device=q.device)
            per.scatter_add_(2, idx[:, None, :].expand(nt, 128, -1),
                             ch.hit.int())
            most = per[:, :, :n_max].view(nt, 4, 32, n_max).amax(dim=2)
            valid = (torch.arange(n_max, device=q.device)[None, :]
                     < ((total + size - 1) // size)[:, None])[:, None, :]
            n[key] += 4 * int(((total + size - 1) // size).sum())
            n[key + "_any"] += int(((most > 0) & valid).sum())
            if size == 32:
                n["busiest"] += int((most * valid).sum())
    return {"pairs": n["hits"], "warp_steps": n["steps"],
            "share_of_steps_with_a_hit": n["steps_any"] / n["steps"],
            "words": n["words"],
            "share_of_words_with_a_hit": n["words_any"] / n["words"],
            "busiest_lane_hits_per_word": n["busiest"] / n["words"],
            "mean_lane_hits_per_word": n["hits"] / (32 * n["words"]),
            "share_of_4_groups_with_a_hit": n["groups_any"] / n["groups"]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from treensearch_tpu_torch.ops import fastpath as fp
    from treensearch_tpu_torch.ops import pairs as P
    from treensearch_tpu_torch.ops import reduce as red

    card = cs.card_line()
    print(f"card: {card}", flush=True)
    src = P.SOURCE.read_text()
    k2a = {"committed": src,
           "branch per 4 tests": substitute(src, DRAIN, BRANCH),
           "tail filled per lane": substitute(src, FILL, FILL_PER_LANE)}
    k3 = {(fn.__name__, bounds): substitute(
              red.kernel_source(red.ReduceSpec(fn, n_out, True), variable)[0],
              K3_BOUNDS, f"__launch_bounds__(TILE, {bounds})")
          for fn, n_out, variable in cs.CALLBACKS for bounds in (8, 10, 12)}
    jobs = {("k2a", k): ("pairs", t) for k, t in k2a.items()}
    jobs.update({("k3", k): ("reduce", t) for k, t in k3.items()})
    with ThreadPoolExecutor(len(jobs)) as ex:
        futures = {k: ex.submit(P.build_library, name, text.encode())
                   for k, (name, text) in jobs.items()}
        libs = {k: f.result() for k, f in futures.items()}
    for (kind, variant), lib in libs.items():
        for kernel, regs, smem, stores, loads in cs.kernel_resources(lib.log):
            if kind == "k3" or kernel == "pairs_nbrs_kernel<false, false, "\
                                        "true>":
                print(json.dumps({"nvcc": [kind, variant, kernel],
                                  "registers": regs, "shared": smem,
                                  "spill_stores": stores,
                                  "spill_loads": loads}), flush=True)

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    pts_t = torch.from_numpy(rng.uniform(0, 1, (cs.N, 3))
                             .astype(np.float32)).to(dev)
    mass_t = torch.from_numpy(rng.uniform(0.5, 1.5, cs.N)
                              .astype(np.float32)).to(dev)
    payload = torch.stack([mass_t, torch.zeros_like(mass_t)], dim=1)
    a, allow, q = cs.active_inputs(cs.make_engine(pts_t, cs.RADIUS),
                                   payload)
    print(json.dumps({"hit_words": hit_words(a, q)}), flush=True)

    # K2a: each variant's launcher on the same inputs and outputs
    k8 = a.k8s[0]
    live = cs.live_slots(a.desc, a.tiles_cap).view(a.tiles_cap, 128)
    counts = torch.empty(a.tiles_cap * 128, dtype=torch.int32, device=dev)
    nbrs = torch.empty((a.tiles_cap, k8, 128), dtype=torch.int32,
                       device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    load_args = P.load_library().lib.tns_pairs_nbrs_fixed.argtypes

    def launch(variant):
        fn = libs[("k2a", variant)].lib.tns_pairs_nbrs_fixed
        fn.argtypes, fn.restype = load_args, ctypes.c_int
        err = fn(a.desc.data_ptr(), q.data_ptr(), a.recs_t.data_ptr(),
                 a.recs_t.shape[1], a.tiles_cap, a.n_win, k8, float(a.r2),
                 counts.data_ptr(), nbrs.data_ptr(), stream)
        if err:
            raise RuntimeError(f"K2a {variant}: CUDA error {err}")

    c_p, nb_p = P.pairs_nbrs_fixed_plain(a.desc, q, a.recs_t, a.r2, a.n_win,
                                         k8, a.tiles_cap)
    for variant in k2a:
        counts.fill_(-7)
        nbrs.fill_(-7)
        launch(variant)
        torch.cuda.synchronize()
        if not (torch.equal(counts.view(a.tiles_cap, 128)[live],
                            c_p.view(a.tiles_cap, 128)[live])
                and torch.equal(nbrs.transpose(1, 2)[live],
                                nb_p.transpose(1, 2)[live])):
            raise AssertionError(f"K2a {variant} differs from plain")
    print(json.dumps({"k2a": _turns(list(k2a), launch, cs, dev),
                      "card": card}), flush=True)

    # K3: the density (n_out 1) and density4_fn (n_out 4) at each bound
    args = (a.desc, q, a.recs_t, a.n_win, a.tiles_cap)
    kw = fp.active_args(a)
    for fn, n_out in ((cs.density_fn, 1), (cs.density4_fn, 4)):
        spec = red.ReduceSpec(fn, n_out, True)
        plain = red.pairs_reduce_plain(*args, spec, a.cand_sets, allow, **kw)
        out = torch.empty_like(plain)
        ids = P.set_ids_arg(a.cand_sets)
        k3_args = red.reduce_library(spec, False).lib.tns_pairs_reduce.argtypes

        def run(bounds, fn=fn):
            lib = libs[("k3", (fn.__name__, bounds))].lib
            lib.tns_pairs_reduce.argtypes = k3_args
            lib.tns_pairs_reduce.restype = ctypes.c_int
            err = lib.tns_pairs_reduce(
                a.desc.data_ptr(), q.data_ptr(), a.recs_t.data_ptr(),
                a.recs_t.shape[1], a.tiles_cap, a.n_win, float(a.r2), 0,
                len(a.cand_sets), ids, allow.data_ptr(), allow.shape[0],
                out.data_ptr(), stream)
            if err:
                raise RuntimeError(f"K3 {bounds}: CUDA error {err}")

        scale = red.pairs_reduce_plain(*args, red.ReduceSpec(
            lambda env, fn=fn: tuple(torch.as_tensor(o).float().abs()
                                     for o in cs._outputs(fn(env))),
            n_out, True), a.cand_sets, allow, **kw)
        for bounds in (8, 10, 12):
            run(bounds)
            torch.cuda.synchronize()
            if not bool(((out - plain).abs()
                         <= cs.REDUCE_RTOL * scale).all()):
                raise AssertionError(f"K3 {fn.__name__} at {bounds} blocks "
                                     "differs from plain")
        print(json.dumps({"k3": fn.__name__,
                          "ms": _turns([8, 10, 12], run, cs, dev),
                          "card": card}), flush=True)
    return 0


def _turns(variants, launch, cs, dev) -> dict:
    """Each variant's time in ROUNDS rounds of turns, the order reversed
    in every other round."""
    times = {str(v): [] for v in variants}
    for r in range(ROUNDS):
        for v in (variants if r % 2 == 0 else variants[::-1]):
            times[str(v)].append(round(cs.median_ms(
                lambda: launch(v), dev, per=cs.KERNEL_BATCH), 4))
    return times


if __name__ == "__main__":
    sys.exit(main())
