#!/usr/bin/env python3
"""The design choices of the split-staging kernel K5, measured on the card.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_variants.py

On K4's bits of BASELINE config 1 (``chip_smoke.py``'s 1M points, r =
0.02, cell 1.15 r, seed 0: one output block, K5's ``ONE_SET`` instance)
and of BASELINE config 3 (400,000 fluid and 100,000 boundary points: two
blocks), each on a settled engine's structures, it prints, each as one
JSON line:

- ``hit_words``: at config 1, from the plain version's hit masks, the
  share of (warp, candidate) steps in which at least one of the warp's 32
  query lanes hits, and, over the stream's 32-candidate groups, the mean
  of the busiest lane's hits per warp and group (what K5's drain pays per
  group) and the share of groups with a hit (the groups whose transpose is
  not skipped);
- ``nvcc``: each variant's registers, shared memory and spills;
- ``k5``: per configuration, each variant's time in four rounds of turns
  (CUDA events, median of 7 runs of 10 calls), after it was found equal to
  the plain version (counts, and rows slot for slot on live tiles).

The variants are ``csrc/pairs.cu`` as committed and built again with one
change each:

- ``bulk copy``: a chunk's bit rows by one TMA bulk copy
  (``cp.async.bulk``, issued by one thread, completing on an
  ``mbarrier``) instead of one 16-byte ``cp.async`` per row;
- ``per-candidate walk``: the earlier design's drain on the same stream,
  each lane testing its own bit of every row, instead of the 32 x 32
  transpose;
- ``word-major rows``: after the wait each thread copies its own rows
  word-major into a second buffer, so the drain's reads hit 32 banks
  instead of 8 (one more shared pass, 8 KB more shared memory);
- ``direct stores`` and ``16 entries`` to ``80 entries``: 0 (every hit
  stored straight to its row) or 16, 24, 40, 48, 64, 80 row entries a
  thread stages in shared memory instead of 32;
- ``8 blocks``, ``16 blocks``: ``__launch_bounds__`` for 8 or 16 resident
  blocks per SM instead of 12;
- and, to show what the rest costs (their counts are checked, not their
  rows): ``no hit stores`` (a hit only counts) and ``no row writes`` (the
  staged entries and the -1 tails are not written out).

Every variant is built by ``nvcc`` into ``build/``; the script fails if a
substitution does not apply, a build fails or a variant disagrees with
the plain version.  It imports nothing of JAX and exits non-zero without
CUDA.
"""

from __future__ import annotations

import ctypes
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROUNDS = 4   # rounds of turns over the variants, the order reversed in odd
K5 = ("pairs_nbrs_from_bits_kernel<true>",
      "pairs_nbrs_from_bits_kernel<false>")

# --- the committed source's pieces that the variants change
DECL = """  __shared__ int4 s_bits[2][CHUNK];
  __shared__ int2 s_id[2][CHUNK];    // (orig, set), then (index, block)
"""
BASE = """  const long long base = cand_base[t];
  __syncthreads();
"""
STAGE = """  auto stage = [&](int c, int buf) {
#pragma unroll
    for (int h = 0; h < CHUNK / TILE; ++h) {
      const int j = h * TILE + l;
      const int k = c * CHUNK + j;
      const long long r = base + k;
      if (k < total && r >= 0 && r < n_bits_rows)
        cp_async16(&s_bits[buf][j], bits + r);
      else
        s_bits[buf][j] = make_int4(0, 0, 0, 0);
"""
WAIT = """    cp_async_wait_all();
#pragma unroll
    for (int h = 0; h < CHUNK / TILE; ++h) {
      const int j = h * TILE + l;
      if (c * CHUNK + j < total) {
        const int2 id = s_id[buf][j];
"""
FINISH_END = """        else
          s_id[buf][j] = make_int2(id.x - off, bi);
      }
    }
  };
"""
DRAIN = """    // warp-uniform groups: every lane takes part in the transpose
    for (int j0 = 0; j0 < m; j0 += WORD) {
      const unsigned x = words[(j0 + lane) * WORDS + warp];
      if (!__any_sync(FULL, x)) continue;
      for (unsigned hits = transpose32(x, lane); hits; hits &= hits - 1)
        append(buf, j0 + __ffs(hits) - 1);
    }
    if (c + 1 < n_chunks) finish(c + 1, buf ^ 1);
    __syncthreads();
"""
APPEND_ONE = """      if (count < e_1)
        s_rows[count * TILE + l] = id.x;
      else if (count < k8_1)
        row[(size_t)count * TILE] = id.x;
      ++count;
"""
APPEND_SETS = """      if (n < min(k8, stage_e))
        s_rows[(id.y * stage_e + n) * TILE + l] = id.x;
      else if (n < k8)
        s_nbrs[id.y][((size_t)t * k8 + n) * TILE + l] = id.x;
      *cnt = n + 1;
"""
FLUSH = """    for (int k = 0; k < e; ++k)
      out[(size_t)k * TILE] = k < n ? staged[k * TILE + l] : -1;
    fill_tail(out, max(n, e), k8);
"""
STAGED = "constexpr int STAGED = 32;"
BOUNDS = """template <bool ONE_SET>
__global__ void __launch_bounds__(TILE, 12)
pairs_nbrs_from_bits_kernel("""

# --- the bulk copy: one thread copies the chunk's rows below n_bits_rows,
# the others zero the rest; every thread waits on the buffer's barrier,
# whose phase flips once per use of the buffer; generic writes to the
# buffers are fenced against the next bulk copy before each barrier
BULK = {
    DECL: DECL + "  __shared__ unsigned long long s_bar[2];\n",
    BASE: """  const long long base = cand_base[t];
  if (l == 0) {
    for (int i = 0; i < 2; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\\n" ::"r"(
                       (unsigned)__cvta_generic_to_shared(&s_bar[i]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");
  }
  __syncthreads();
""",
    STAGE: """  auto stage = [&](int c, int buf) {
    const long long r0 = base + (long long)c * CHUNK;
    const int n_copy = r0 < 0 ? 0 : (int)max(0LL, min(
        (long long)min(CHUNK, total - c * CHUNK), n_bits_rows - r0));
    if (l == 0) {
      const unsigned bar = (unsigned)__cvta_generic_to_shared(&s_bar[buf]);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\\n"
                   ::"r"(bar), "r"(n_copy * 16) : "memory");
      if (n_copy > 0)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1], %2, [%3];\\n" ::"r"(
                (unsigned)__cvta_generic_to_shared(&s_bits[buf][0])),
            "l"(bits + r0), "r"(n_copy * 16), "r"(bar) : "memory");
    }
#pragma unroll
    for (int h = 0; h < CHUNK / TILE; ++h) {
      const int j = h * TILE + l;
      const int k = c * CHUNK + j;
      if (j >= n_copy) s_bits[buf][j] = make_int4(0, 0, 0, 0);
""",
    WAIT: """    cp_async_wait_all();
    {
      const unsigned bar = (unsigned)__cvta_generic_to_shared(&s_bar[buf]);
      unsigned done = 0;
      while (!done)
        asm volatile("{\\n .reg .pred p;\\n"
                     " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\\n"
                     " selp.u32 %0, 1, 0, p;\\n}\\n"
                     : "=r"(done)
                     : "r"(bar), "r"((unsigned)((c >> 1) & 1))
                     : "memory");
    }
#pragma unroll
    for (int h = 0; h < CHUNK / TILE; ++h) {
      const int j = h * TILE + l;
      if (c * CHUNK + j < total) {
        const int2 id = s_id[buf][j];
""",
    DRAIN: DRAIN.replace(
        "    __syncthreads();\n",
        '    asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");\n'
        "    __syncthreads();\n"),
}
# --- the earlier drain: each lane tests its own bit of every row
WALK = {DRAIN: """    for (int j = 0; j < m; ++j)
      if (words[j * WORDS + warp] & (1u << lane)) append(buf, j);
    if (c + 1 < n_chunks) finish(c + 1, buf ^ 1);
    __syncthreads();
"""}
# --- the rows copied word-major after the wait, read without conflicts
WORD_MAJOR = {
    DECL: DECL + "  __shared__ unsigned s_wm[2][TILE / 32][CHUNK];\n",
    FINISH_END: """        else
          s_id[buf][j] = make_int2(id.x - off, bi);
      }
    }
#pragma unroll
    for (int h = 0; h < CHUNK / TILE; ++h) {
      const int j = h * TILE + l;
      const int4 v = s_bits[buf][j];
      s_wm[buf][0][j] = v.x;
      s_wm[buf][1][j] = v.y;
      s_wm[buf][2][j] = v.z;
      s_wm[buf][3][j] = v.w;
    }
  };
""",
    DRAIN: DRAIN.replace("words[(j0 + lane) * WORDS + warp]",
                         "s_wm[buf][warp][j0 + lane]"),
}
VARIANTS = {"committed": {}, "bulk copy": BULK, "per-candidate walk": WALK,
            "word-major rows": WORD_MAJOR,
            "direct stores": {STAGED: STAGED.replace("32", "0")},
            **{f"{e} entries": {STAGED: STAGED.replace("32", str(e))}
               for e in (16, 24, 40, 48, 64, 80)},
            "8 blocks": {BOUNDS: BOUNDS.replace("12", "8")},
            "16 blocks": {BOUNDS: BOUNDS.replace("12", "16")},
            # what the rest costs: the counts stay right, the rows do not
            "no hit stores": {APPEND_ONE: "      ++count;\n",
                              APPEND_SETS: "      *cnt = n + 1;\n"},
            "no row writes": {FLUSH: ""}}
DIAGNOSTIC = ("no hit stores", "no row writes")


def substitute(text: str, subs: dict) -> str:
    for old, new in subs.items():
        if text.count(old) != 1:
            raise RuntimeError(f"substitution does not apply: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def hit_words(a, q) -> dict:
    """The hit statistics of these inputs (one set, fixed radius), from the
    plain pairs version's hit masks, chunk of tiles by chunk of tiles."""
    import torch
    from treensearch_tpu_torch.ops import pairs as P
    n = {"steps": 0, "steps_any": 0, "words": 0, "words_any": 0,
         "busiest": 0, "hits": 0}
    for ch in P._plain_chunks(a.desc, q, a.recs_t, a.n_win, a.tiles_cap,
                              a.r2, False):
        nt = ch.t1 - ch.t0
        n["hits"] += int(ch.hit.sum())
        n["steps"] += 4 * int(ch.ok.sum())
        n["steps_any"] += int((ch.hit.view(nt, 4, 32, -1).any(dim=2)
                               & ch.ok[:, None, :]).sum())
        # the stream index of each window slot, and its group of 32
        k = torch.cumsum(ch.ok.int(), dim=1) - 1
        total = ch.ok.sum(dim=1)
        n_max = int((total.max() + 31) // 32)
        idx = torch.where(ch.ok, k // 32, n_max).long()
        per = torch.zeros((nt, 128, n_max + 1), dtype=torch.int32,
                          device=q.device)
        per.scatter_add_(2, idx[:, None, :].expand(nt, 128, -1),
                         ch.hit.int())
        most = per[:, :, :n_max].view(nt, 4, 32, n_max).amax(dim=2)
        valid = (torch.arange(n_max, device=q.device)[None, :]
                 < ((total + 31) // 32)[:, None])[:, None, :]
        n["words"] += 4 * int(((total + 31) // 32).sum())
        n["words_any"] += int(((most > 0) & valid).sum())
        n["busiest"] += int((most * valid).sum())
    return {"pairs": n["hits"], "warp_steps": n["steps"],
            "share_of_steps_with_a_hit": n["steps_any"] / n["steps"],
            "groups": n["words"],
            "share_of_groups_with_a_hit": n["words_any"] / n["words"],
            "busiest_lane_hits_per_group": n["busiest"] / n["words"],
            "mean_lane_hits_per_group": n["hits"] / (32 * n["words"])}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from treensearch_tpu_torch.ops import fastpath as fp
    from treensearch_tpu_torch.ops import pairs as P

    card = cs.card_line()
    print(f"card: {card}", flush=True)
    src = P.SOURCE.read_text()
    texts = {v: substitute(src, subs) for v, subs in VARIANTS.items()}
    with ThreadPoolExecutor(len(texts)) as ex:
        futures = {v: ex.submit(P.build_library, "pairs", t.encode())
                   for v, t in texts.items()}
        libs = {v: f.result() for v, f in futures.items()}
    for variant, lib in libs.items():
        for kernel, regs, smem, stores, loads in cs.kernel_resources(lib.log):
            if kernel in K5:
                print(json.dumps({"nvcc": [variant, kernel],
                                  "registers": regs, "shared": smem,
                                  "spill_stores": stores,
                                  "spill_loads": loads}), flush=True)

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    pts_t = torch.from_numpy(rng.uniform(0, 1, (cs.N, 3))
                             .astype(np.float32)).to(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    load_args = P.load_library().lib.tns_pairs_nbrs_from_bits.argtypes
    for label, eng in (("config 1", cs.make_engine(pts_t, cs.RADIUS)),
                       ("config 3", cs.config3_engine(*cs.config3_data(dev)))):
        a, allow, q = cs.active_inputs(eng)
        if label == "config 1":
            print(json.dumps({"hit_words": hit_words(a, q)}), flush=True)
        _, bits, base = P.pairs_mask(a.desc, q, a.recs_t, a.n_win,
                                     a.tiles_cap, a.cand_sets, allow,
                                     **fp.active_args(a))
        blocks = (a.cand_sets, a.cand_offsets, a.k8s)
        c_p, nb_p = P.pairs_nbrs_from_bits_plain(
            a.desc, a.recs_t, bits, base, a.n_win, a.tiles_cap, *blocks)
        counts, nbrs, args = P._block_outputs(blocks, a.tiles_cap, dev)
        live = a.desc[:a.tiles_cap, 127] != 2

        def launch(variant, a=a, bits=bits, base=base, args=args):
            fn = libs[variant].lib.tns_pairs_nbrs_from_bits
            fn.argtypes, fn.restype = load_args, ctypes.c_int
            err = fn(a.desc.data_ptr(), a.recs_t.data_ptr(),
                     a.recs_t.shape[1], a.tiles_cap, a.n_win,
                     bits.data_ptr(), bits.shape[0], base.data_ptr(), *args,
                     stream)
            if err:
                raise RuntimeError(f"K5 {variant}: CUDA error {err}")

        for variant in VARIANTS:
            counts.fill_(-7)
            for nb in nbrs:
                nb.fill_(-7)
            launch(variant)
            torch.cuda.synchronize()
            if not (torch.equal(counts, c_p) and (
                    variant in DIAGNOSTIC or all(
                        torch.equal(k[live], p[live])
                        for k, p in zip(nbrs, nb_p)))):
                raise AssertionError(f"K5 {variant} differs from plain at "
                                     f"{label}")
        print(json.dumps({"k5": label, "blocks": len(a.k8s),
                          "candidate_rows": bits.shape[0],
                          "ms": _turns(list(VARIANTS), launch, cs, dev),
                          "card": card}), flush=True)
        del eng, a, allow, q, bits, base, c_p, nb_p, counts, nbrs
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
