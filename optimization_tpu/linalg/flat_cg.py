"""Single-synchronization Steihaug-Toint CG engines for flat tangent spaces.

The memory/latency-bound specialization of
:mod:`optimization_tpu.linalg.stpcg` (the BASELINE "TNT on a
10^6+-variable problem" north star).  Same functional contract as the
reference STPCG (``LinearAlgebra/IterativeSolvers.h:166-426``): truncation
target |r_k| <= |r_0| min(kappa_fgr, |r_0|^theta), negative-curvature/
overlong boundary exit with the sigma steplength, kernel-of-H escape with
descent alignment, and the |s|/<s,p>/|p| trust-region recurrences.

**Structured operator**: H v = A0(v) + U B (U' v) with A0 a cheap fusible
*elementwise* linear map (recomputed freely inside fusions, never
materialized), U a tuple of a few (n,) vectors (or nullary generators), B a
(k, k) symmetric coupling.

TWO engines share this contract behind :func:`stpcg_flat`:

1. **The pair-deferred engine** (``s_steps=1``, default): one
   fused ~6n-word pass + ONE reduction sync per CG iteration
   (Chronopoulos-Gear kappa, q = Hp recomputed elementwise in-pass,
   s-updates merged across unrolled iteration pairs).  Every scalar
   assembly stays at moment order <= 2, so its f32 noise floor is the
   plain sqrt(n)*eps dot-product floor.  Production path for huge-n
   trust-region subproblems.

2. **The s-step coefficient-space engine** (``s_steps >= 2``):
   ONE reduction sync per s CG iterations, exact parity with the generic
   engine (demotion around every exit), vmap-safe, with a plain-linear-
   solver mode (``solve_mode``).  Its larger reduction group (~30-45
   outputs) and register chains are harder for XLA to keep in one fusion
   than engine 1's, and its order-3/4 honest moment dots carry a
   sqrt(n)*eps relative noise floor that engine 1's order-<=2 assemblies
   do not.  It is kept, fully tested, for regimes where loop syncs
   dominate; every current default is engine 1.

**How s steps ride one reduction** (engine 2).  Every vector the group
manipulates
(p_t, r_t, the s-update) lives in the Krylov coefficient space over the
basis  {H^i r, H^i p}_{i=0..2s}  of the group's two input vectors.  The
group's ONE reduction supplies honest dots of the *previous* group's
outputs:

- moments  h_m = (<H^i r, H^j r>, <H^i r, H^j p>, <H^i p, H^j p>),
  i + j = m <= 2s, which populate the Gram matrix of the basis, so every
  scalar CG needs (beta_t, kappa_t = <p_t, H p_t>, alpha_t, rv_t,
  |q_t|^2 for the kernel test, <p_t, r_t>, |p_t|^2) is a tiny bilinear
  form evaluated on-chip between passes;
- low-rank dots  a_j = U'(A0^j v), j <= 2s-1, which (with the precomputed
  k x k couplings  G_j = U'(A0^j U)) close the recurrence
  U'(H^m v) = c_{0,m},  c_{i,m} = c_{i+1,m-1} + G_i B c_{0,m-1},
  c_{i,0} = a_i,  so H^m v is formed *exactly* in registers inside the next
  pass: V_{m} = A0(V_{m-1}) + U B U'(H^{m-1} v) with the U-dot a carried
  scalar, never a fresh reduction.

The pass then materializes the committed r/p/s outputs as basis combos,
H-chains them to depth s, and accumulates the next group's honest dot set
in the same fusion.  Nothing is approximated: in exact arithmetic the
iterates equal the generic engine's (pinned by tests/test_flat_cg.py and
the hypothesis property suite).

**Exit semantics / demotion.**  Step 0 of a group implements the full
reference semantics (truncation via the loop condition, kernel escape with
descent alignment, boundary sigma step).  A *later* step in the group is
taken only when it is provably an interior CG step with a well-conditioned
scalar assembly: if step t >= 1 would hit the boundary/kernel/truncation,
exceed max_iterations, or its kappa/rv/|q|^2 assemblies show heavy
cancellation (> ~1-CANCEL_GUARD of the absolute mass cancels), the group
COMMITS ONLY the steps before it ("demotion").  The next group then
re-derives that step from fresh honest dots through the step-0 path, so
demotion is semantically invisible — it only costs one extra sync, paid at
most once per subproblem exit.  f32's high-power moment noise therefore
never changes *what* the solver computes, only how many steps share a sync.

Storage-dtype generic: vectors may be bf16; every dot accumulates in (at
least) f32 and every materialized output casts back to the storage dtype.

The sphere Rayleigh-quotient Hessian fits the contract exactly via its
symmetrization  P H P = A0 + U B U'  with  A0 = 2A - rq I  (elementwise for
diagonal/generated A),  U = (x, 2Ax),  B = [[2 rq, -1], [-1, 0]]
(``models``/benchmarks build this via ``sphere_rayleigh_flat``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

__all__ = ["FlatCGResult", "FlatCGInit", "stpcg_flat", "flat_init_dots",
           "sphere_rayleigh_flat", "sphere_rayleigh_step"]

# A step-t (t>=1) scalar assembly is trusted only if the surviving value
# exceeds this fraction of the absolute mass of its terms; below it the
# step is demoted to the next group's honest dots.  Semantically invisible
# (see module docstring) — tuned so f32 high-power moments never decide a
# knife-edge, while interior steps of well-conditioned subproblems (the
# headline regime) essentially never demote.
CANCEL_GUARD = 1e-4


class FlatCGResult(NamedTuple):
    s: jnp.ndarray
    update_step_M_norm: jnp.ndarray
    num_iterations: jnp.ndarray
    # Predicted model decrease  -(<g,s> + 1/2 <s,Hs>)  tracked by scalar
    # recurrence (interior CG step: +1/2 alpha rv; boundary step along p:
    # -(sigma sign <r,p> + 1/2 sigma^2 kappa)) — algebraically identical to
    # the reference's explicit  dm = -<g,h> - 1/2 <h,Hh>  (TNT.h:511-521)
    # but free: TNT's gain ratio needs no extra Hessian application.
    predicted_decrease: jnp.ndarray


def _acc_dt(x):
    return jnp.promote_types(x.dtype, jnp.float32)


def _dot(a, b):
    dt = jnp.promote_types(_acc_dt(a), _acc_dt(b))
    return jnp.sum(a.astype(dt) * b.astype(dt))


class _UEntry(NamedTuple):
    """A normalized low-rank vector: ``mat()`` materializes it (f32+ ok,
    callers cast), ``dot(v)`` computes ``<u, v>`` in f32+, and
    ``mat_scaled(c)`` materializes ``c * u`` with the (loop-varying)
    scalar folded INSIDE the generating expression — for (base, elem_fn)
    entries this is ``elem_fn(c * base)``, denying XLA the loop-invariant
    ``elem_fn(base)`` subexpression it could otherwise hoist and
    materialize.  (Kept as the defensive form: one reassociation rounding
    is its only semantic difference.)"""
    mat: Callable[[], jnp.ndarray]
    dot: Callable[[jnp.ndarray], jnp.ndarray]
    mat_scaled: Callable[[jnp.ndarray], jnp.ndarray]


def _norm_U(U, B, sdt):
    """Normalize the low-rank term to (tuple of :class:`_UEntry`, B).

    Accepted entry forms:
    - an (n,) array — stored vector, read from device memory where used;
    - a nullary callable returning the vector — regenerated where used
      (NB: XLA CSE + loop-invariant code motion may still materialize a
      repeatedly-used regenerated vector once and re-read it);
    - a ``(base, elem_fn)`` pair with ``elem_fn`` a LINEAR, SELF-ADJOINT,
      ELEMENTWISE map: the entry is ``u = elem_fn(base)``, and every dot
      uses the adjoint identity ``<u, v> = <base, elem_fn(v)>`` so the
      reduction reads only ``base`` and regenerates the weighting inside
      its own fusion — ``u`` itself is never a reduction input.  This is
      the form for operator-derived vectors like y = 2 A x: it removes
      the engine's largest extra memory stream."""
    if U is None or len(U) == 0:
        return (), jnp.zeros((0, 0), sdt)

    def norm(u):
        if isinstance(u, _UEntry):      # idempotent (engines re-normalize)
            return u
        if isinstance(u, tuple):
            base, elem = u
            return _UEntry(mat=lambda: elem(base),
                           dot=lambda v: _dot(base, elem(v)),
                           mat_scaled=lambda c: elem(
                               c * base.astype(_acc_dt(base))))
        if callable(u):
            return _UEntry(mat=u, dot=lambda v: _dot(u(), v),
                           mat_scaled=lambda c: c * u().astype(
                               _acc_dt(u())))
        return _UEntry(mat=lambda: u, dot=lambda v: _dot(u, v),
                       mat_scaled=lambda c: c * u.astype(_acc_dt(u)))

    return tuple(norm(u) for u in U), jnp.asarray(B, sdt)


class FlatCGInit(NamedTuple):
    """The pair engine's init reduction group over r0 = g (see
    :func:`flat_init_dots`): supplying it to :func:`stpcg_flat` removes
    every pre-loop memory pass and reduction sync from the engine — the
    caller computed these dots inside an earlier fused pass that already
    held g and U in registers (e.g. the TNT trial-step evaluator,
    ``sphere_rayleigh_step``)."""

    rv: jnp.ndarray           # <g, g>
    ar: jnp.ndarray           # <A0 g, g>
    nr: jnp.ndarray           # |A0 g|^2
    m: jnp.ndarray            # U' g                 (k,)
    mA: jnp.ndarray           # U' (A0 g)            (k,)
    UU: jnp.ndarray           # U' U                 (k, k)


def flat_init_dots(g, A0, U, B=None) -> FlatCGInit:
    """Compute the pair engine's init dot group for ``stpcg_flat(init=)``.

    Exactly the reductions ``_stpcg_flat_pair`` would run before its loop
    (same accumulation dtypes and order, so threading the result through
    ``init=`` is numerically invisible).  Call it where ``g`` and the ``U``
    vectors are already live in registers of a fused pass — e.g. inside a
    ``RiemannianProblem.step_eval`` — and XLA folds the whole CG init into
    that pass's reduction group instead of paying a separate pre-loop pass
    + sync per outer iteration.
    """
    sdt = _acc_dt(g)
    if U is not None and len(U) and B is None:
        raise ValueError("flat_init_dots: B is required when U is "
                         "non-empty (same contract as stpcg_flat)")
    U, B = _norm_U(U, B, sdt)
    k_lr = len(U)

    def Udots(v):
        if k_lr == 0:
            return jnp.zeros((0,), sdt)
        return jnp.stack([u.dot(v) for u in U])

    A0g = A0(g).astype(sdt)
    UU = (jnp.stack([Udots(u.mat()) for u in U]) if k_lr
          else jnp.zeros((0, 0), sdt))
    return FlatCGInit(rv=_dot(g, g), ar=_dot(A0g, g), nr=_dot(A0g, A0g),
                      m=Udots(g), mA=Udots(A0g), UU=UU)


class _PairState(NamedTuple):
    """Only THREE n-vectors are carried (s, r, p): q = Hp is recomputed
    elementwise inside the pass from p and the scalar recurrence
    U'p_k = -U'r_k + beta_k U'p_{k-1}, so the fused pass reads s/r/p/U and
    writes s/r/p — ~(6+k)n words per CG iteration."""

    k: jnp.ndarray
    s: jnp.ndarray
    r: jnp.ndarray
    p: jnp.ndarray            # p_{k-1}
    # reduction-group results (computed in pass k-1, over r_k and p_{k-1}):
    rv: jnp.ndarray           # <r_k, r_k>
    ar: jnp.ndarray           # <A0 r_k, r_k>
    nr: jnp.ndarray           # |A0 r_k|^2
    m: jnp.ndarray            # U' r_k               (k_lr,)
    mA: jnp.ndarray           # U' (A0 r_k)          (k_lr,)
    pa: jnp.ndarray           # <A0 r_k, A0 p_{k-1}>
    mB: jnp.ndarray           # U' (A0 p_{k-1})      (k_lr,)
    nAp: jnp.ndarray          # |A0 p_{k-1}|^2
    mp: jnp.ndarray           # U' p_{k-1}           (k_lr,) scalar recurrence
    # scalar recurrences:
    rv_prev: jnp.ndarray      # <r_{k-1}, r_{k-1}>
    alpha_prev: jnp.ndarray
    pr: jnp.ndarray           # <p_{k-1}, r_{k-1}>
    kappa_prev: jnp.ndarray
    s_p: jnp.ndarray          # <s_{k-1}, p_{k-1}>
    sk2: jnp.ndarray          # |s_k|^2
    pp_prev: jnp.ndarray      # |p_{k-1}|^2
    mval: jnp.ndarray         # model value <g,s_k> + 1/2 <s_k, H s_k>
    done: jnp.ndarray
    boundary: jnp.ndarray


def _stpcg_flat_pair(
    g: jnp.ndarray,
    A0: Callable[[jnp.ndarray], jnp.ndarray],
    U: Optional[jnp.ndarray],
    B: Optional[jnp.ndarray],
    Delta,
    *,
    max_iterations: int = 1000,
    kappa_fgr: float = 0.1,
    theta: float = 0.5,
    epsilon: float = 1e-8,
    init: Optional[FlatCGInit] = None,
    body_kind: str = "pair",
    kernel_check: bool = True,
) -> FlatCGResult:
    """The pair-deferred engine: ONE fused ~6n-word pass + ONE reduction
    sync per CG iteration (s updates merged across unrolled iteration
    pairs, q = Hp recomputed elementwise, Chronopoulos-Gear kappa, all
    assemblies at moment order <= 2).  The production path for huge-n
    trust-region subproblems: its reduction group is small enough for XLA
    to keep each iteration in one fusion.

    ``init`` (a :class:`FlatCGInit` from :func:`flat_init_dots`) supplies
    the pre-loop dot group, removing every memory pass and reduction sync
    before the while loop.

    ``kernel_check=False`` drops the kernel-of-H safeguard
    (``IterativeSolvers.h:163-165,300-338``: |Hp| < eps |p| -> walk to the
    boundary with descent-aligned sign).  Everything the safeguard needs —
    the |q_k|^2 recurrence (ww/wq/qq) and its fresh anchors nr = |A0 r|^2
    and pa = <A0 r, A0 p> — then dead-codes out of the per-iteration pass.
    An op-count cut; no device measured yet has gained from it (see
    benchmarks/probe_ugroup.py), so every default keeps the safeguard.
    Semantics change ONLY on subproblems where some CG
    direction has |Hp| < 1e-8 |p|: such a step now exits through the
    negative-curvature/trust-region boundary branch with positive sign
    instead of the kernel branch's descent alignment (the alignment
    differs only when <r,p> > 0, which exact CG never produces — see the
    sign adjudication at linalg/stpcg.py).  Opt in when the quadratic
    model certifies no eps-kernel along tangent directions (e.g. the
    sphere Rayleigh Hessian away from an eps-degenerate spectral gap).
    """
    n = g.shape[0]
    dtype = g.dtype
    sdt = _acc_dt(g)

    # U is a TUPLE of flat (n,) vectors: an (n, k) array with a tiny
    # trailing dim k lays out badly on an accelerator (k padded up to its
    # tile width) and multiplies the term's memory traffic.
    # An entry may also be a NULLARY CALLABLE returning the vector: it is
    # then regenerated elementwise inside every fusion instead of being
    # stored and re-read from memory (e.g. y = 2 A x for elementwise A).
    U, B = _norm_U(U, B, sdt)
    k_lr = len(U)

    Delta = jnp.asarray(Delta, sdt)
    Delta2 = Delta * Delta
    zero = jnp.zeros((), sdt)

    def Udots(v):
        """U' v accumulated in f32+: (k_lr,)."""
        if k_lr == 0:
            return jnp.zeros((0,), sdt)
        return jnp.stack([u.dot(v) for u in U])

    def H_of(v, mv):
        """H v given mv = U'v (elementwise + small-rank broadcast; each
        term via mat_scaled so no loop-invariant u is hoisted)."""
        out = A0(v).astype(sdt)
        if k_lr:
            c = B @ mv
            for j in range(k_lr):
                out = out + U[j].mat_scaled(c[j]).astype(sdt)
        return out

    # --- initialization: r0 = g, p_{-1} = 0, beta_0 = 0.  The dot group
    # (and UU below) comes from the caller when supplied — zero pre-loop
    # passes/syncs — else is computed here via the same helper. ---
    r0 = g
    if init is None:
        init = flat_init_dots(g, A0, U, B)
    rv0, ar0, nr0, m0, mA0 = init.rv, init.ar, init.nr, init.m, init.mA

    r0_norm = jnp.sqrt(rv0)
    target = r0_norm * jnp.minimum(jnp.asarray(kappa_fgr, sdt),
                                   r0_norm ** theta)

    st0 = _PairState(
        k=jnp.zeros((), jnp.int32),
        s=jnp.zeros_like(g), r=r0,
        p=jnp.zeros_like(g),
        rv=rv0, ar=ar0, nr=nr0, m=m0, mA=mA0,
        pa=zero, mB=jnp.zeros((k_lr,), sdt), nAp=zero,
        mp=jnp.zeros((k_lr,), sdt),
        rv_prev=zero, alpha_prev=jnp.ones((), sdt),
        pr=zero, kappa_prev=jnp.ones((), sdt),
        s_p=zero, sk2=zero, pp_prev=zero, mval=zero,
        done=jnp.asarray(False), boundary=jnp.asarray(False),
    )

    eps2 = jnp.asarray(epsilon, sdt) ** 2
    UU = init.UU

    def cond(st: _State):
        return ((st.k < max_iterations) & ~st.done
                & (jnp.sqrt(st.rv) > target))

    def half(st: _State, pend, apply_s: bool):
        """One CG iteration of the x2-unrolled loop body.

        ``s`` is touched only in the applying half: the deferring half
        returns its step coefficient (on the p it just formed) as ``pend``,
        and the applying half folds ``pend * p_prev`` into its own s update
        — both vectors it reads anyway — so the deferring half's fused pass
        moves 5n words and the applying half 7n (avg 6n/iteration) instead
        of 7n each.  ``frozen`` gates everything so exits fire with
        identical semantics whichever half they land in (the while cond is
        only evaluated between pairs)."""
        frozen = (st.done | (st.k >= max_iterations)
                  | (jnp.sqrt(st.rv) <= target))

        first = st.rv_prev == 0
        beta = jnp.where(first, zero, st.rv / jnp.where(first, 1.0,
                                                        st.rv_prev))

        # <w_k, r_k> = <A0 r,r> + (U'r)' B (U'r);  kappa via Chronopoulos-
        # Gear:  kappa_k = <w_k,r_k> - (beta/alpha_{k-1}) rv_k
        Bm = B @ st.m
        wr = st.ar + st.m @ Bm
        kappa = wr - (beta / st.alpha_prev) * st.rv

        # |p_k|^2 = rv + beta^2 |p_{k-1}|^2
        pp_k = st.rv + beta * beta * st.pp_prev
        # <p_k, r_k> = -rv + beta (<p,r>_{k-1} + alpha_{k-1} kappa_{k-1})
        pr_k = -st.rv + beta * (st.pr + st.alpha_prev * st.kappa_prev)
        # <s_k, p_k> = beta (<s_{k-1},p_{k-1}> + alpha_{k-1}|p_{k-1}|^2)
        sp_k = beta * (st.s_p + st.alpha_prev * st.pp_prev)

        if kernel_check:
            # |w_k|^2, <w_k, q_{k-1}>, |q_{k-1}|^2 from the carried dot
            # group (w = A0 r + U B U'r, q_{k-1} = A0 p_{k-1} + U B
            # U'p_{k-1}; UU = U'U precomputed outside the loop)
            Bmp = B @ st.mp
            ww = st.nr + 2.0 * (st.mA @ Bm) + Bm @ (UU @ Bm)
            wq = st.pa + st.mA @ Bmp + Bm @ st.mB + Bm @ (UU @ Bmp)
            qq_prev = st.nAp + 2.0 * (st.mB @ Bmp) + Bmp @ (UU @ Bmp)
            # |q_k|^2 = |w|^2 - 2 beta <w, q_{k-1}> + beta^2 |q_{k-1}|^2
            qq_k = ww - 2.0 * beta * wq + beta * beta * qq_prev
            in_kernel = qq_k < eps2 * pp_k
            sign = jnp.where(in_kernel & (pr_k > 0), -jnp.ones((), sdt),
                             jnp.ones((), sdt))
        else:
            # kernel safeguard disabled (see engine docstring): the |q|^2
            # machinery and its anchors (nr/pa/nAp) dead-code out of the
            # fused pass below.
            in_kernel = jnp.asarray(False)
            sign = jnp.ones((), sdt)
        sp_eff = sign * sp_k
        disc = sp_eff * sp_eff + pp_k * (Delta2 - st.sk2)
        sigma = (-sp_eff + jnp.sqrt(jnp.maximum(disc, 0.0))) \
            / jnp.maximum(pp_k, jnp.finfo(sdt).tiny)

        alpha = st.rv / kappa
        sk2_next = st.sk2 + 2.0 * alpha * sp_k + alpha * alpha * pp_k
        boundary = (in_kernel | (kappa <= 0) | (sk2_next > Delta2)) & ~frozen

        cs = jnp.where(boundary, sigma * sign, alpha).astype(sdt)
        cs = jnp.where(frozen, zero, cs)
        cr = jnp.where(boundary | frozen, zero, alpha)

        # model value: interior CG step decreases it by alpha rv / 2; the
        # boundary step from s_k along sigma*sign*p_k adds
        # sigma sign <r_k,p_k> + 1/2 sigma^2 kappa_k  (all tracked scalars)
        m_int = st.mval - 0.5 * alpha * st.rv
        m_bnd = st.mval + sigma * sign * pr_k + 0.5 * sigma * sigma * kappa
        m_new = jnp.where(frozen, st.mval,
                          jnp.where(boundary, m_bnd, m_int))

        # U'p_k = -U'r_k + beta U'p_{k-1} (scalar recurrence): q_k is then
        # recomputed elementwise from p_k instead of being carried.
        mp_k = -st.m + beta * st.mp

        # --- THE pass: form p, recompute q = H p elementwise, update r
        # (and s in the applying half), accumulate the dot group ---
        p2 = (-st.r.astype(sdt) + beta * st.p.astype(sdt))
        q2 = H_of(p2, mp_k)
        r2 = (st.r.astype(sdt) + cr * q2).astype(dtype)
        if apply_s:
            s2 = (st.s.astype(sdt) + pend * st.p.astype(sdt)
                  + cs * p2).astype(dtype)
            pend_out = zero
        else:
            s2 = st.s
            pend_out = cs
        p2 = p2.astype(dtype)

        # U'(A0 p_k) and |A0 p_k|^2 by exact order-2 recurrences on the
        # carried group (p_k = -r_k + beta p_{k-1}):
        #   U'(A0 p_k) = -U'(A0 r_k) + beta U'(A0 p_{k-1})
        #   |A0 p_k|^2 = |A0 r_k|^2 - 2 beta <A0 r_k, A0 p_{k-1}>
        #                + beta^2 |A0 p_{k-1}|^2
        # — the same class as the |q_k|^2 recurrence above, anchored each
        # half by the fresh nr/pa/mA dots, which replace three fresh
        # reductions (and A0 p's only reduction-side consumer).
        mB2 = -st.mA + beta * st.mB
        # U'r_{k+1} by the same exact order-2 class:  r2 = r + cr q2 with
        # q2 = A0 p2 + U B (U'p2),  so  U'r2 = U'r + cr (U'(A0 p2)
        # + (U'U) B (U'p2)) — every term already carried/known.  The mp
        # recurrence stays anchored by mA2's fresh dots each half.
        m2 = st.m + cr * (mB2 + (UU @ (B @ mp_k) if k_lr else mB2 * 0))
        A0r2 = A0(r2).astype(sdt)
        rv2 = _dot(r2, r2)
        ar2 = _dot(A0r2, r2)
        mA2 = Udots(A0r2)
        if kernel_check:
            A0p2 = A0(p2).astype(sdt)
            nr2 = _dot(A0r2, A0r2)
            pa2 = _dot(A0r2, A0p2)
            nAp2 = st.nr - 2.0 * beta * st.pa + beta * beta * st.nAp
        else:
            nr2 = pa2 = nAp2 = zero

        exit_now = boundary | frozen

        return _PairState(
            k=jnp.where(exit_now, st.k, st.k + 1),
            s=s2,
            r=jnp.where(exit_now, st.r, r2),
            p=p2,
            rv=jnp.where(exit_now, st.rv, rv2),
            ar=ar2, nr=nr2, m=m2, mA=mA2,
            pa=pa2, mB=mB2, nAp=nAp2, mp=mp_k,
            rv_prev=jnp.where(exit_now, st.rv_prev, st.rv),
            alpha_prev=jnp.where(exit_now, st.alpha_prev, alpha),
            pr=jnp.where(exit_now, st.pr, pr_k),
            kappa_prev=jnp.where(exit_now, st.kappa_prev, kappa),
            s_p=jnp.where(exit_now, st.s_p, sp_k),
            sk2=jnp.where(exit_now, st.sk2, sk2_next),
            pp_prev=jnp.where(exit_now, st.pp_prev, pp_k),
            mval=m_new,
            done=st.done | boundary,
            boundary=jnp.where(frozen, st.boundary, boundary),
        ), pend_out

    if body_kind == "single":
        # One half per while iteration: s applied every pass (7n words vs
        # the pair's 6n average), with the body's live set at the four
        # loop vectors.
        def body(st: _State) -> _State:
            st1, _ = half(st, zero, apply_s=True)
            return st1
    elif body_kind == "pair":
        # Pair-deferred: two halves per while iteration, the first
        # deferring its s coefficient into the second's fused s update —
        # fewer words per iteration, but half 1's outputs + half 2's
        # outputs double the body's live vectors.
        def body(st: _State) -> _State:
            st1, pend = half(st, zero, apply_s=False)
            st2, _ = half(st1, pend, apply_s=True)
            return st2
    else:
        raise ValueError(f"body_kind must be 'single' or 'pair', "
                         f"not {body_kind!r}")

    st = jax.lax.while_loop(cond, body, st0)

    update_step_M_norm = jnp.where(st.boundary, Delta, jnp.sqrt(st.sk2))
    return FlatCGResult(s=st.s, update_step_M_norm=update_step_M_norm,
                        num_iterations=st.k,
                        predicted_decrease=-st.mval)




def _fold_prec(g, A0, U, B, prec, sdt):
    """Symmetric preconditioner folding: the change of variables s = P shat
    with P = ``prec`` (an elementwise, linear, self-adjoint, positive map
    applying M^{-1/2}) turns the M-preconditioned trust-region subproblem
    into a PLAIN one over (ghat, A0hat, Uhat, B):

        ghat = P g,   A0hat = P A0 P,   Uhat_j = P U_j.

    Euclidean norms in the transformed space ARE the reference's
    preconditioned norms: |rhat| = |r|_{M^{-1}} (the truncation norm,
    ``IterativeSolvers.h:275-291``) and |shat| = |s|_M (the trust-region /
    step norm tracked by the M-norm recurrences,
    ``IterativeSolvers.h:388-420``), so running the unmodified engine on
    the transformed data reproduces the reference's preconditioned STPCG
    exactly, at ZERO extra streams per iteration when ``prec`` is a
    generated elementwise map (the composition fuses).
    """
    U, B = _norm_U(U, B, sdt)

    def wrap(u: _UEntry) -> _UEntry:
        # self-adjointness: <P u, v> = <u, P v>, so the transformed dot
        # reuses the entry's own (possibly adjoint-form) reduction.
        return _UEntry(mat=lambda: prec(u.mat()),
                       dot=lambda v: u.dot(prec(v)),
                       mat_scaled=lambda c: prec(u.mat_scaled(c)))

    ghat = prec(g.astype(sdt)).astype(g.dtype)
    A0hat = lambda v: prec(A0(prec(v)).astype(sdt))
    return ghat, A0hat, tuple(wrap(u) for u in U), B


def stpcg_flat(
    g: jnp.ndarray,
    A0: Callable[[jnp.ndarray], jnp.ndarray],
    U,
    B,
    Delta,
    *,
    max_iterations: int = 1000,
    kappa_fgr: float = 0.1,
    theta: float = 0.5,
    epsilon: float = 1e-8,
    s_steps: int = 1,
    solve_mode: bool = False,
    init: Optional[FlatCGInit] = None,
    body_kind: str = "pair",
    kernel_check: bool = True,
    prec: Optional[Callable[[jnp.ndarray], jnp.ndarray]] = None,
) -> FlatCGResult:
    """Approximately solve  min <g,s> + 1/2 <s, Hs>  s.t. |s| <= Delta  for
    H = A0 + U B U', with STPCG truncation/boundary/kernel semantics.

    - ``A0``: elementwise (diagonal-like) *linear* operator; called on
      register vectors many times per pass and expected to fuse (never
      materialized across passes).
    - ``U``: tuple of (n,) vectors and/or nullary callables regenerating
      them elementwise (not an (n, k) array: its tiny trailing dim would be
      padded to the device's tile width); ``B``: (k, k) symmetric.
      Pass None/None for a purely elementwise Hessian.
    - ``body_kind`` (pair engine): ``"pair"`` (default) runs two CG
      iterations per loop body with a deferred s update (~6n words per
      iteration), ``"single"`` one (~7n).  Semantics are identical (both
      parity-tested against the generic engine); only the words/iteration
      vs live-vector trade differs.  The pair body was faster in both
      tiers of the headline TNT at n = 2^24 on an H100 (PERF.md); no other
      size has been timed on the card.
    - ``s_steps``: CG iterations advanced per reduction sync (1..3).
      ``1`` (default) runs the pair-deferred engine — one fused ~6n-word
      pass + one sync per iteration, assemblies at moment order <= 2 —
      the default for huge-n subproblems.  ``>= 2`` runs the
      coefficient-space s-step engine, one sync per s iterations: use it
      where the per-sync charge dominates the pass (small n, cheap or
      preconditioned operators, e.g. the marginalized inner Laplacian
      solves); at n=2^24 its larger reduction group is harder to fuse
      (module docstring).
    - ``solve_mode``: run as a plain truncated CG *linear solver* for
      H s = -g (pass ``g = -rhs``, read the solution from ``s``): on a
      curvature/kernel breakdown the engine stops at the current iterate
      instead of taking the trust-region sigma-step to the boundary.  Use
      with ``Delta = inf`` and ``theta = 0`` so the truncation target is the
      plain relative-residual tolerance ``kappa_fgr * |r0|``.  This is the
      communication-avoiding inner-solver seam (e.g. the marginalized
      SE-Sync translation-Laplacian solve, models/pose_sync.py).
    - ``prec``: optional ELEMENTWISE, linear, self-adjoint, positive map
      applying M^{-1/2} (e.g. ``lambda v: v * jax.lax.rsqrt(d_gen())`` for a
      Jacobi preconditioner with generated diagonal d).  Folds the
      preconditioner in symmetrically (:func:`_fold_prec`): truncation runs
      in the |.|_{M^{-1}} residual norm and the trust region / reported
      step norm in the |.|_M norm — exactly the reference's preconditioned
      STPCG semantics (``IterativeSolvers.h:236-291,388-420``) — at zero
      extra streams per iteration when ``prec`` is generated elementwise.
      The one semantic deviation: the kernel-of-H epsilon safeguard tests
      the TRANSFORMED operator (|P H P p| < eps |p|), not H itself — an
      epsilon-regime difference only.  Works with both engines and
      solve_mode; incompatible with ``init=``.  Non-elementwise
      rank-deficiency projectors still fold into the U B U' term
      (pose_sync does).
    - vmap-safe: under ``jax.vmap`` the while_loop body keeps executing on
      lanes whose own condition already failed; every state write is gated
      on the lane's live-ness so finished lanes are bit-frozen.
    - ``init``: optional :class:`FlatCGInit` from :func:`flat_init_dots`
      computed in an earlier fused pass (e.g. a TNT ``step_eval``); the
      pair engine then runs zero passes/syncs before its loop.  Pair
      engine only.
    - ``kernel_check=False`` (pair engine only) drops the kernel-of-H
      epsilon safeguard and with it the |q|^2 recurrence plus its fresh
      anchor dots (nr/pa).  Only for subproblems certifying no eps-kernel
      along CG directions (see :func:`_stpcg_flat_pair`'s docstring for
      the exact semantics delta); defaults keep the safeguard.
    """
    if prec is not None:
        if init is not None:
            raise ValueError(
                "init= (the precomputed pre-loop dot group) is computed in "
                "untransformed coordinates and cannot be combined with "
                "prec=; compute the group on the transformed data instead")
        sdt = _acc_dt(g)
        ghat, A0hat, Uhat, Bhat = _fold_prec(g, A0, U, B, prec, sdt)
        res = stpcg_flat(ghat, A0hat, Uhat, Bhat, Delta,
                         max_iterations=max_iterations, kappa_fgr=kappa_fgr,
                         theta=theta, epsilon=epsilon, s_steps=s_steps,
                         solve_mode=solve_mode, body_kind=body_kind,
                         kernel_check=kernel_check)
        # un-transform the step; the M-norm and model decrease are already
        # the reference's preconditioned quantities (see _fold_prec).
        return res._replace(
            s=prec(res.s.astype(sdt)).astype(g.dtype))
    if s_steps <= 1 and not solve_mode:
        return _stpcg_flat_pair(g, A0, U, B, Delta,
                                max_iterations=max_iterations,
                                kappa_fgr=kappa_fgr, theta=theta,
                                epsilon=epsilon, init=init,
                                body_kind=body_kind,
                                kernel_check=kernel_check)
    if init is not None:
        raise ValueError(
            "init= (the precomputed pre-loop dot group) is only supported "
            "by the pair engine (s_steps=1, solve_mode=False); the s-step "
            "engine's init set is the depth-2S moment/low-rank group")
    if not kernel_check:
        raise ValueError(
            "kernel_check=False is a pair-engine optimization (s_steps=1, "
            "solve_mode=False); the s-step engine keeps the safeguard")
    return _stpcg_flat_sstep(g, A0, U, B, Delta,
                             max_iterations=max_iterations,
                             kappa_fgr=kappa_fgr, theta=theta,
                             epsilon=epsilon, s_steps=s_steps,
                             solve_mode=solve_mode)


class _State(NamedTuple):
    """Only THREE n-vectors are carried (s, r, p); everything else is the
    honest dot set of the previous pass plus scalar recurrences."""

    k: jnp.ndarray
    s: jnp.ndarray
    r: jnp.ndarray
    p: jnp.ndarray
    h: jnp.ndarray            # (2s+1, 3) moments [<.,.>_rr, _rp, _pp]
    a: jnp.ndarray            # (2s, 2, k) U'(A0^j r), U'(A0^j p)
    rv_prev: jnp.ndarray      # <r,r> of the previous committed iterate
    alpha_prev: jnp.ndarray
    s_p: jnp.ndarray          # <s, p> after the last committed step
    sk2: jnp.ndarray          # |s|^2
    mval: jnp.ndarray         # model value <g,s> + 1/2 <s,Hs>
    done: jnp.ndarray
    boundary: jnp.ndarray


def _stpcg_flat_sstep(
    g: jnp.ndarray,
    A0: Callable[[jnp.ndarray], jnp.ndarray],
    U,
    B,
    Delta,
    *,
    max_iterations: int = 1000,
    kappa_fgr: float = 0.1,
    theta: float = 0.5,
    epsilon: float = 1e-8,
    s_steps: int = 2,
    solve_mode: bool = False,
) -> FlatCGResult:
    """The s-step coefficient-space engine (module docstring); dispatched
    from :func:`stpcg_flat` for s_steps >= 2 (and for solve_mode at s=1).
    """
    n = g.shape[0]
    dtype = g.dtype
    sdt = _acc_dt(g)
    S = max(1, min(int(s_steps), 3))
    K = 2 * S                   # max H-power whose moments are carried
    dim = 2 * (K + 1)           # coefficient basis {H^i r}_{0..K} + {H^i p}

    U, B = _norm_U(U, B, sdt)
    k_lr = len(U)

    Delta = jnp.asarray(Delta, sdt)
    Delta2 = Delta * Delta
    zero = jnp.zeros((), sdt)
    one = jnp.ones((), sdt)
    eps2 = jnp.asarray(epsilon, sdt) ** 2
    guard = jnp.asarray(CANCEL_GUARD, sdt)

    def Udots(v):
        """U' v accumulated in f32+: (k,)."""
        if k_lr == 0:
            return jnp.zeros((0,), sdt)
        return jnp.stack([u.dot(v) for u in U])

    def lowrank(c):
        """U B c as a register vector (elementwise regeneration)."""
        out = None
        if k_lr:
            d = B @ c
            for j in range(k_lr):
                term = d[j] * U[j].mat().astype(sdt)
                out = term if out is None else out + term
        return out

    def H_of(v, uv):
        """H v = A0 v + U B (U'v) given the carried/recurred scalar U'v."""
        out = A0(v).astype(sdt)
        lr = lowrank(uv)
        return out if lr is None else out + lr

    # --- k x k couplings G_j = U'(A0^j U), j <= K-2 (setup-only dots) ---
    Gs = []
    if k_lr:
        cols = [u.mat().astype(sdt) for u in U]
        for j in range(max(K - 1, 1)):
            Gs.append(jnp.stack([Udots(c) for c in cols]).T)  # [i,l]=u_i'A0^j u_l
            cols = [A0(c).astype(sdt) for c in cols]
    else:
        Gs = [jnp.zeros((0, 0), sdt)] * max(K - 1, 1)

    def u_chain(a_v):
        """u_m = U'(H^m v) for m <= K-1 from honest a_j = U'(A0^j v).

        c_{i,m} = U'(A0^i H^m v):  c_{i,0} = a_i,
        c_{i,m} = c_{i+1,m-1} + G_i B c_{0,m-1}  (exact, linearity only).
        """
        c = {(i, 0): a_v[i] for i in range(K)}
        for m in range(1, K):
            for i in range(K - m):
                c[(i, m)] = c[(i + 1, m - 1)] + Gs[i] @ (B @ c[(0, m - 1)])
        return [c[(0, m)] for m in range(K)]

    # --- coefficient-space helpers (length-dim vectors over the basis) ---
    def basis(i, block):
        e = [zero] * dim
        e[block * (K + 1) + i] = one
        return e

    def shift(co):
        """Coefficients of H * (the vector with coefficients co)."""
        out = [zero] * dim
        for b in range(2):
            for i in range(K):
                out[b * (K + 1) + i + 1] = co[b * (K + 1) + i]
        return out

    # Coefficient ops preserve the literal ``zero`` so the static Krylov
    # support (<= t+1 basis entries after t steps) prunes every bilinear
    # form and materialization at trace time.
    def axpy_co(a_, x_co, y_co):
        out = []
        for x_, y_ in zip(x_co, y_co):
            if x_ is zero:
                out.append(y_)
            elif y_ is zero:
                out.append(a_ * x_)
            else:
                out.append(a_ * x_ + y_)
        return out

    def scale_co(a_, x_co):
        return [zero if x_ is zero else a_ * x_ for x_ in x_co]

    def where_co(c, x_co, y_co):
        return [zero if (x_ is zero and y_ is zero) else jnp.where(c, x_, y_)
                for x_, y_ in zip(x_co, y_co)]

    def mom_entry(h, i, j, b1, b2, absval=False):
        m = i + j
        if m > K:
            return zero  # only reachable with a zero coefficient
        col = {(0, 0): 0, (0, 1): 1, (1, 0): 1, (1, 1): 2}[(b1, b2)]
        v = h[m, col]
        return jnp.abs(v) if absval else v

    def bilin(h, x_co, y_co, absval=False):
        """x' Gram y over the basis; absval=True gives the absolute mass
        |x|' |Gram| |y| used by the cancellation guard."""
        tot = zero
        for ia in range(dim):
            b1, i = divmod(ia, K + 1)
            if x_co[ia] is zero:
                continue
            for ja in range(dim):
                b2, j = divmod(ja, K + 1)
                if y_co[ja] is zero or i + j > K:
                    continue
                xa = jnp.abs(x_co[ia]) if absval else x_co[ia]
                ya = jnp.abs(y_co[ja]) if absval else y_co[ja]
                term = xa * ya * mom_entry(h, i, j, b1, b2, absval)
                tot = term if tot is zero else tot + term
        return tot

    # --- initialization: honest dot set of (r0 = g, p_{-1} = 0) ---
    r0 = g
    r0f = r0.astype(sdt)
    Vr = [r0f]
    for m in range(S):
        Vr.append(H_of(Vr[m], Udots(Vr[m])))
    h0 = []
    for m in range(K + 1):
        i = min(m, S)
        h0.append(jnp.stack([_dot(Vr[i], Vr[m - i]), zero, zero]))
    h0 = jnp.stack(h0)                                  # (K+1, 3)
    a0 = []
    acc = r0f
    for j in range(K):
        a0.append(jnp.stack([Udots(acc), jnp.zeros((k_lr,), sdt)]))
        acc = A0(acc).astype(sdt)
    a0 = (jnp.stack(a0) if K else jnp.zeros((0, 2, k_lr), sdt))

    rv0 = h0[0, 0]
    r0_norm = jnp.sqrt(rv0)
    target = r0_norm * jnp.minimum(jnp.asarray(kappa_fgr, sdt),
                                   r0_norm ** theta)
    target2 = target * target

    st0 = _State(
        k=jnp.zeros((), jnp.int32),
        s=jnp.zeros_like(g), r=r0, p=jnp.zeros_like(g),
        h=h0, a=a0,
        rv_prev=zero, alpha_prev=one,
        s_p=zero, sk2=zero, mval=zero,
        done=jnp.asarray(False), boundary=jnp.asarray(False),
    )

    def cond(st: _State):
        return ((st.k < max_iterations) & ~st.done
                & (st.h[0, 0] > target2))

    def body(st: _State) -> _State:
        h = st.h
        # Lane live-ness (same predicate as ``cond``): under vmap the body
        # executes on lanes whose own condition failed; gate every commit
        # and state write so finished lanes are bit-frozen.
        live = ((st.k < max_iterations) & ~st.done
                & (h[0, 0] > target2))

        # ---------- scalar phase: plan up to S steps in coefficient space
        r_co = basis(0, 0)
        p_prev_co = basis(0, 1)
        rv = h[0, 0]
        rv_prev = st.rv_prev
        alpha_prev = st.alpha_prev
        pp_prev = h[0, 2]
        s_p, sk2, mval = st.s_p, st.sk2, st.mval

        committed = live
        n_comm = jnp.zeros((), jnp.int32)
        exit_boundary = jnp.asarray(False)
        # outputs (selected per committed step count)
        out_r_co, out_p_co = r_co, p_prev_co
        out_sadd_co = [zero] * dim
        out_rv, out_rvp = rv, rv_prev
        out_ap = alpha_prev
        out_sp, out_sk2, out_mval = s_p, sk2, mval

        for t in range(S):
            first = rv_prev == 0
            beta = jnp.where(first, zero,
                             rv / jnp.where(first, one, rv_prev))
            p_co = axpy_co(beta, p_prev_co, scale_co(-one, r_co))
            Sp_co = shift(p_co)
            kappa = bilin(h, p_co, Sp_co)
            qq = bilin(h, Sp_co, Sp_co)
            ppn = bilin(h, p_co, p_co)
            pr = bilin(h, p_co, r_co)

            in_kernel = qq < eps2 * ppn
            sign = jnp.where(in_kernel & (pr > 0), -one, one)
            sp_t = beta * (s_p + alpha_prev * pp_prev)
            sp_eff = sign * sp_t
            disc = sp_eff * sp_eff + ppn * (Delta2 - sk2)
            sigma = (-sp_eff + jnp.sqrt(jnp.maximum(disc, 0.0))) \
                / jnp.maximum(ppn, jnp.finfo(sdt).tiny)

            if solve_mode:
                sigma = zero   # breakdown => stop at the current iterate

            alpha = rv / kappa
            sk2_next = sk2 + 2.0 * alpha * sp_t + alpha * alpha * ppn
            boundary_t = in_kernel | (kappa <= 0) | (sk2_next > Delta2)

            r_next_co = axpy_co(alpha, Sp_co, r_co)
            rv_next = bilin(h, r_next_co, r_next_co)

            if t == 0:
                # full reference semantics: interior step, or sigma-step to
                # the boundary (kernel escape sign included) and exit.  In
                # solve_mode a breakdown stops at the current iterate (no
                # boundary step) — plain linear-solver semantics.
                take_int = committed & ~boundary_t
                take_bnd = committed & boundary_t
                coeff = jnp.where(take_bnd, sigma * sign,
                                  jnp.where(take_int, alpha, zero))
                out_sadd_co = axpy_co(coeff, p_co, out_sadd_co)
                out_p_co = p_co
                out_r_co = where_co(take_int, r_next_co, out_r_co)
                out_rv = jnp.where(take_int, rv_next, out_rv)
                out_rvp = jnp.where(take_int, rv, out_rvp)
                out_ap = jnp.where(take_int, alpha, out_ap)
                # carried <s,p> convention: the BEFORE-step value of the
                # last formed p (next group adds alpha_prev*pp_prev itself)
                out_sp = jnp.where(take_int, sp_t, out_sp)
                out_sk2 = jnp.where(
                    take_int, sk2_next,
                    jnp.where(take_bnd, sk2 + 2.0 * sigma * sp_eff
                              + sigma * sigma * ppn, out_sk2))
                out_mval = jnp.where(
                    take_int, mval - 0.5 * alpha * rv,
                    jnp.where(take_bnd, mval + sigma * sign * pr
                              + 0.5 * sigma * sigma * kappa, out_mval))
                n_comm = n_comm + jnp.where(take_int, 1, 0)
                exit_boundary = take_bnd
                committed = take_int
            else:
                # interior-only: demote on any exit-ish condition, iteration
                # limit, truncation, or heavy cancellation in the scalar
                # assemblies (module docstring).
                trunc = rv <= target2
                over = st.k + t + 1 > max_iterations
                kap_mass = bilin(h, p_co, Sp_co, absval=True)
                qq_mass = bilin(h, Sp_co, Sp_co, absval=True)
                rv_mass = bilin(h, r_next_co, r_next_co, absval=True)
                shaky = ((jnp.abs(kappa) < guard * kap_mass)
                         | (qq < guard * qq_mass)
                         | (rv_next < guard * rv_mass))
                take = committed & ~(boundary_t | trunc | over | shaky)
                # select AFTER the product: planning coefficients can be
                # inf/NaN when step 0 exited (alpha = rv/0 on a kernel
                # step), and 0 * NaN would poison the accumulator.
                out_sadd_co = where_co(take,
                                       axpy_co(alpha, p_co, out_sadd_co),
                                       out_sadd_co)
                out_p_co = where_co(take, p_co, out_p_co)
                out_r_co = where_co(take, r_next_co, out_r_co)
                out_rv = jnp.where(take, rv_next, out_rv)
                out_rvp = jnp.where(take, rv, out_rvp)
                out_ap = jnp.where(take, alpha, out_ap)
                out_sp = jnp.where(take, sp_t, out_sp)
                out_sk2 = jnp.where(take, sk2_next, out_sk2)
                out_mval = jnp.where(take, mval - 0.5 * alpha * rv, out_mval)
                n_comm = n_comm + jnp.where(take, 1, 0)
                committed = take

            # advance the planning scalars for the next t
            mval = mval - 0.5 * alpha * rv
            rv_prev, rv = rv, rv_next
            alpha_prev = alpha
            pp_prev = ppn
            s_p = sp_t
            sk2 = sk2_next
            r_co, p_prev_co = r_next_co, p_co

        # ---------- the pass: materialize outputs, H-chain them, and
        # accumulate the next honest dot set, all in ONE fusion group.
        u_r = u_chain([st.a[j, 0] for j in range(K)]) if K else []
        u_p = u_chain([st.a[j, 1] for j in range(K)]) if K else []

        rf = st.r.astype(sdt)
        pf = st.p.astype(sdt)
        Vr = [rf]
        Vp = [pf]
        for m in range(S):
            Vr.append(H_of(Vr[m], u_r[m]))
            Vp.append(H_of(Vp[m], u_p[m]))

        def u_of(co, i=0):
            """U' (H^i x_co) by exact recurrence (no reduction).

            Support <= S and i <= S-1 keep every index within the carried
            u-chain (m + i <= 2S - 1 = K - 1)."""
            tot = jnp.zeros((k_lr,), sdt)
            for m in range(S + 1):
                for b, u_ch in ((0, u_r), (1, u_p)):
                    cmb = co[b * (K + 1) + m]
                    if cmb is zero:
                        continue
                    assert m + i < K, "Krylov support exceeded"
                    tot = tot + cmb * u_ch[m + i]
            return tot

        def mat(co):
            """Materialize a coefficient vector (support <= S) in registers."""
            tot = None
            for m in range(S + 1):
                for b, V in ((0, Vr), (1, Vp)):
                    cmb = co[b * (K + 1) + m]
                    if cmb is zero:
                        continue
                    term = cmb * V[m]
                    tot = term if tot is None else tot + term
            return tot if tot is not None else jnp.zeros_like(Vr[0])

        R0 = mat(out_r_co)
        P0 = mat(out_p_co)
        s_new = (st.s.astype(sdt) + mat(out_sadd_co)).astype(dtype)
        r_new = R0.astype(dtype)
        p_new = P0.astype(dtype)

        # H-chains of the outputs to depth S (U-dots by exact recurrence)
        Rch = [R0]
        Pch = [P0]
        for i in range(S):
            Rch.append(H_of(Rch[i], u_of(out_r_co, i)))
            Pch.append(H_of(Pch[i], u_of(out_p_co, i)))

        h_new = []
        for m in range(K + 1):
            i = min(m, S)
            j = m - i
            h_new.append(jnp.stack([
                _dot(Rch[i], Rch[j]),
                _dot(Rch[i], Pch[j]),
                _dot(Pch[i], Pch[j]),
            ]))
        h_new = jnp.stack(h_new)

        a_rows = []
        accR, accP = R0, P0
        for j in range(K):
            a_rows.append(jnp.stack([Udots(accR), Udots(accP)]))
            if j + 1 < K:
                accR = A0(accR).astype(sdt)
                accP = A0(accP).astype(sdt)
        a_new = (jnp.stack(a_rows) if K else st.a)

        return _State(
            k=st.k + n_comm,
            s=jnp.where(live, s_new, st.s),
            r=jnp.where(live, r_new, st.r),
            p=jnp.where(live, p_new, st.p),
            h=jnp.where(live, h_new, st.h),
            a=jnp.where(live, a_new, st.a),
            rv_prev=jnp.where(live, out_rvp, st.rv_prev),
            alpha_prev=jnp.where(live, out_ap, st.alpha_prev),
            s_p=jnp.where(live, out_sp, st.s_p),
            sk2=jnp.where(live, out_sk2, st.sk2),
            mval=jnp.where(live, out_mval, st.mval),
            done=st.done | exit_boundary,
            boundary=st.boundary | exit_boundary,
        )

    st = jax.lax.while_loop(cond, body, st0)

    update_step_M_norm = jnp.where(st.boundary, Delta, jnp.sqrt(st.sk2))
    return FlatCGResult(s=st.s, update_step_M_norm=update_step_M_norm,
                        num_iterations=st.k,
                        predicted_decrease=-st.mval)


class SphereStepAux(NamedTuple):
    """The ``sphere_rayleigh_step`` aux carry: the trial Rayleigh quotient
    plus the flat engine's pre-loop dot group at the trial point (TNT
    selects it on accept/reject alongside x/f/grad, so the next CG solve
    starts with ZERO reductions — on a rejected step the iterate, gradient,
    and therefore the whole group are unchanged)."""

    rq: jnp.ndarray
    init: FlatCGInit


def sphere_rayleigh_step(A_elem, with_init: bool = True):
    """Fused TNT trial-step evaluator for f(x) = <x, A x> on S^{n-1}
    (the ``RiemannianProblem.step_eval`` seam; A applied elementwise by
    ``A_elem``, f32+ accumulation).

    Everything the outer iteration needs derives from the *unnormalized*
    trial point u = x + h in ONE fused pass with one reduction group
    (three dots): with n2 = <u,u>, fu = <u, Au>, na2 = |Au|^2 and
    c = 1/sqrt(n2),

        x_prop = c u,                      f_prop = fu / n2,
        rq'    = 2 f_prop,                 grad   = 2c Au - rq' c u,
        |grad|^2 = 4 na2 / n2 - rq'^2,

    algebraically identical to retract -> f -> proj(2 A x_prop) (the
    projection identity: <x_p, 2A x_p> = rq').  This replaces separate
    retraction/objective/gradient passes per outer iteration with a single
    ~4n-word pass + one sync.

    Returns ``step_eval(x, h, data) -> (x_prop, f_prop, grad, gradnorm,
    aux)`` with ``aux`` a :class:`SphereStepAux`: the trial Rayleigh
    quotient plus (``with_init=True``) the flat engine's pre-loop dot
    group (:func:`flat_init_dots`) evaluated HERE, on the cast trial
    point/gradient, inside this same fused pass — x_prop, g, and A(...)
    chains are all register values, so the extra dots ride this pass's
    reduction group for free.  TNT threads aux into
    ``flat_qm(x, data, aux)``, which forwards ``aux.init`` to
    ``stpcg_flat(init=)``: the next outer iteration then runs NO memory
    pass and NO reduction sync between the while-loop back-edge and the
    first CG iteration.

    NB: TNT seeds the carry by calling this at (x0, h=0), whose outputs
    describe the NORMALIZED x0 — while TNT's own f0/grad0 are evaluated
    at x0 as given.  Pass a (near-)unit x0 so the seeded group is
    consistent with the first subproblem's actual gradient (bench.py and
    every test do; the discrepancy is one rounding of |x0| - 1).
    """
    def step_eval(x, h, data):
        sdt = _acc_dt(x)
        u = x.astype(sdt) + h.astype(sdt)
        au = A_elem(u).astype(sdt)
        n2 = jnp.sum(u * u)
        fu = jnp.sum(u * au)
        na2 = jnp.sum(au * au)
        c = 1.0 / jnp.sqrt(n2)
        f_prop = fu / n2
        rqp = 2.0 * f_prop
        x_prop = (c * u).astype(x.dtype)
        g = ((2.0 * c) * au - (rqp * c) * u).astype(x.dtype)
        if not with_init:
            # |grad| by the algebraic identity 4 na2/n2 - rq'^2: ONE
            # reduction group, but catastrophic cancellation near the
            # optimum (the terms are ~rq'^2 >> |g|^2, so the f32 floor is
            # ~sqrt(eps)*rq' ~ 1e-3 at rq'~2) — fine for fixed-effort
            # benchmarking, NOT for tight gradient-tolerance termination.
            gn = jnp.sqrt(jnp.maximum(4.0 * na2 / n2 - rqp * rqp, 0.0))
            return x_prop, f_prop, g, gn, SphereStepAux(rq=rqp, init=None)
        # The dot group the next CG solve needs, computed on the CAST
        # x_prop/g exactly as the engine itself would (same helper, same
        # accumulation), so init-threading is numerically invisible.
        A0p, Up, Bp, _ = sphere_rayleigh_flat(x_prop, A_elem, rq=rqp)
        init = flat_init_dots(g, A0p, Up, Bp)
        # |grad| from the init group's <g, g>: an explicit
        # sum-of-squared-residual-entries, cancellation-free (the
        # identity form above underflows to 0 near the optimum and a
        # GRADIENT stop would fire on a corrupted norm — observed on the
        # escalation benchmark at |g|_true ~ 1e-3).  Free: the dot
        # already rides the init reduction group.
        gn = jnp.sqrt(init.rv)
        return x_prop, f_prop, g, gn, SphereStepAux(rq=rqp, init=init)

    return step_eval


def sphere_rayleigh_flat(x, A_elem, rq=None):
    """Flat-operator structure of the sphere Rayleigh-quotient Hessian.

    For f(x) = <x, A x> on S^{n-1} (A symmetric, applied elementwise by
    ``A_elem``), the symmetrized Riemannian Hessian  P H P  at unit x is

        A0 = 2A - rq I,   U = (x, 2Ax),   B = [[2 rq, -1], [-1, 0]],

    with rq = <x, 2Ax>.  On tangent vectors this equals the usual
    one-sided-projected Hessian  proj_x(2Av) - rq v  exactly; off the
    tangent space it is the symmetric extension CG needs.

    Returns ``(A0, U, B, rq)``.
    """
    y = 2.0 * A_elem(x)
    if rq is None:
        rq = _dot(x, y)

    def A0(v):
        return 2.0 * A_elem(v) - rq * v.astype(_acc_dt(v))

    # y = 2 A x enters as the ADJOINT-FORM pair (x, 2A.): every <y, v>
    # reduction computes <x, 2A v> with the elementwise weighting
    # regenerated inside the consuming fusion, so the engine's reductions
    # read only x (which the pass reads anyway) and y is materialized
    # solely where the Hessian application adds c1*y.  (A nullary-callable
    # form is defeated by XLA CSE + loop-invariant code motion: the
    # "regenerated" y is hoisted, materialized to device memory, and
    # re-read by every consumer kernel.)
    U = (x, (x, lambda v: 2.0 * A_elem(v)))
    B = jnp.asarray([[2.0 * rq, -1.0], [-1.0, 0.0]], _acc_dt(x))
    return A0, U, B, rq
