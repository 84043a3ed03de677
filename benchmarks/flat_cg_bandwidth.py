"""The flat CG engine's memory traffic against the card's copy rate.

    python benchmarks/flat_cg_bandwidth.py [--n-log2 24] [--reps 3]

For n = 2^24 in f32 and bf16 storage and both loop bodies of the flat
engine (``single``: one CG iteration per loop body; ``pair``: two, with the
s update deferred), the headline TNT solve (``bench.run_tier``) is timed at
two caps on CG iterations per subproblem, 50 and 25.  The outer iterations
are the same in both, so the difference of the walls over the difference of
the CG counts is the time of one CG iteration without the outer-iteration
cost.  The bytes one iteration moves (``bench.words_per_cg``: 7n words for
single, 6n for pair) over that time is the engine's achieved rate.

In the same process a large device copy (a reversal: XLA elides a plain
copy inside a loop) and an elementwise scale, one read and one write each,
of 2^28 f32 words are timed, each as the slope of a
loop of 8 against a loop of 24 passes (which cancels the dispatch): a
hand-written kernel of the engine's kind can at best reach that rate.

One line per measurement; the last line is a JSON summary.
"""

import argparse
import json
import time

import jax
import jax.numpy as jnp

from _util import device_label, device_peaks

import bench


def stream_rate(fn, words=1 << 28, reps=5, k_lo=8, k_hi=24):
    """Best GB/s of ``fn`` (one read + one write of ``words`` f32 per
    pass): the time of ``k_hi`` dependent passes less that of ``k_lo``."""
    x = jnp.ones(words, jnp.float32)

    def chain(k):
        return jax.jit(lambda a: jax.lax.fori_loop(
            0, k, lambda i, v: fn(v), a))

    def best(f):
        jax.block_until_ready(f(x))
        t = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(f(x))
            t = min(t, time.perf_counter() - t0)
        return t

    per_pass = (best(chain(k_hi)) - best(chain(k_lo))) / (k_hi - k_lo)
    return 2 * 4 * words / per_pass / 1e9


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-log2", type=int, default=24)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    n = 1 << args.n_log2
    print(f"# {device_label()}", flush=True)

    rows = []
    for name, dtype, tol in (("f32", jnp.float32, 1e-5),
                             ("bf16", jnp.bfloat16, 0.0)):
        for body in ("single", "pair"):
            full = bench.run_tier(n, dtype, tol, max_tpcg=50,
                                  body_kind=body, reps=args.reps)
            half = bench.run_tier(n, dtype, tol, max_tpcg=25,
                                  body_kind=body, reps=args.reps)
            per_cg = ((full.seconds - half.seconds)
                      / max(full.inner - half.inner, 1))
            nbytes = bench.words_per_cg(body) * n * jnp.dtype(dtype).itemsize
            row = dict(dtype=name, body=body, outer=full.outer,
                       outer_half=half.outer, cg=full.inner,
                       cg_half=half.inner, wall_s=full.seconds,
                       wall_half_s=half.seconds, fstar=full.fstar,
                       cg_per_s=full.cg_per_s, per_cg_s=per_cg,
                       gbps=nbytes / per_cg / 1e9)
            rows.append(row)
            print(json.dumps(row), flush=True)

    # each pass reads the previous pass's result, so none is dead
    copy = stream_rate(lambda a: a[::-1])
    scale = stream_rate(lambda a: a * 1.0000001)
    print(f"copy {copy:.1f} GB/s, scale {scale:.1f} GB/s (2^28 f32 words, "
          f"one read + one write per pass, 24-pass minus 8-pass slope)",
          flush=True)
    hbm = device_peaks()["hbm_gbps"]
    best = max(copy, scale)
    for r in rows:
        r.update(of_copy=r["gbps"] / best, of_published=r["gbps"] / hbm)
    print(json.dumps(dict(n=n, copy_gbps=copy, scale_gbps=scale,
                          published_hbm_gbps=hbm, rows=rows)), flush=True)


if __name__ == "__main__":
    main()
