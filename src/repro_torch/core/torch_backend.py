"""Torch execution backend for the batch engines: the counterpart of the
reference's ``core/jax_backend.py``, function for function.

Every batch engine (dispatch scoring, the client engine's greedy passes,
the world's accrual and completion passes, the validation digests) runs on
NumPy by default. ``backend="torch"`` runs the dense inner passes as eager
torch ops on the engine's device, while the sparse host-side tails (group
resolution, lexsort ordering, per-row locality adjustments, REC debits, the
``np.add.reduce`` and ``bincount`` folds) stay on the NumPy code. The
contract is the reference's: scalar oracle ⇒ NumPy engine ⇒ device engine,
bit for bit, asserted whole-run by the 4th axis of ``core/scenarios.run_parity``.

The reference's FMA staging law, restated for torch. Each rule names a
way a pass that is right on the CPU goes wrong on the card or against
NumPy:

  * **No division by a Python float.** On CUDA, ``t / x`` with ``x`` a
    CPU scalar computes ``t * (1/x)``, which may lose a bit; on the CPU
    torch divides exactly, so only the card shows it. Every divisor here is
    a tensor on the engine's device (``_scalar``): a 0-dim CPU tensor is
    still a CPU scalar.
  * **Explicit dtypes.** torch promotes otherwise than NumPy (a bool tensor
    times a float is float32, ``torch.zeros(n)`` is float32, an int tensor
    over 2 is float32): every tensor is made with ``float64`` (``int64``
    indices, ``bool`` masks).
  * **No product fused into a sum.** No ``torch.compile``, no ``torch.jit``,
    no ``addcmul``/``addcdiv``/``lerp``/``addmm``/``baddbmm``: an eager
    ``mul`` then ``add`` rounds the product, as NumPy does. The weighted
    score sum keeps NumPy's order, ``((t_kw (+ t_bal)) + t_pr) + t_sk``.
  * **No device reduction in place of a fold.** ``torch.sum`` does not add
    in NumPy's order. Every accumulation is a row-sequential loop in the
    NumPy engine's order, a vector op across hosts at each row.
  * **Host syncs, never fallbacks.** Results come back with ``.cpu()``;
    nothing here catches a device error and carries on in NumPy, and
    nothing checks for a card to pick the CPU: the device is the engine's.

Elementwise add, sub, mul, div by a device tensor, compares, ``where``,
boolean logic, gathers and scatters are exact IEEE operations in f64 on
both the CPU and the card, so these passes equal NumPy's bits.
The reference pads to power-of-two buckets to bound jit retraces; eager
ops do not retrace, so nothing is padded here. The world's columns stay
resident on the device between passes and are updated in place.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

F64 = torch.float64


def _up(a, device: torch.device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A NumPy array as a new tensor on ``device`` (never a view of it)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype or t.dtype, copy=True)


def _down(t: torch.Tensor) -> np.ndarray:
    """A device tensor as a new NumPy array (a host sync)."""
    return t.to("cpu", copy=True).numpy()


def _scalar(x: float, device: torch.device) -> torch.Tensor:
    """A 0-dim float64 tensor on ``device``: a divisor there is a tensor,
    never a CPU scalar (see the module docstring)."""
    return torch.full((), x, dtype=F64, device=device)


# ----------------------------------------------------------------------
# dispatch (core/batch_dispatch.candidate_rows)
# ----------------------------------------------------------------------


def dispatch_elig(valid: np.ndarray, target: np.ndarray, start: int, host_id: int,
                  device: torch.device) -> np.ndarray:
    """Rotated-scan eligibility mask on the device; entry j refers to feeder
    position ``(start + j) % n`` (the caller's ``rot`` order)."""
    v = torch.roll(_up(valid, device), -start)
    t = torch.roll(_up(target, device, torch.int64), -start)
    return _down(v & ((t < 0) | (t == host_id)))


def dispatch_group_mask(g_ok_inv: np.ndarray, hr_rep: np.ndarray, host_hr_rep: np.ndarray,
                        kok: np.ndarray, device: torch.device) -> np.ndarray:
    ok = _up(np.stack([g_ok_inv, kok]), device)
    hr = _up(np.stack([hr_rep, host_hr_rep]), device, torch.int64)
    hr_ok = (hr[0] == -1) | (hr[0] == hr[1])
    return _down(ok[0] & hr_ok & ok[1])


def dispatch_scores(
    kvec: np.ndarray,
    bal: Optional[np.ndarray],
    prio: np.ndarray,
    skips: np.ndarray,
    flop: np.ndarray,
    pf: np.ndarray,
    avail: float,
    weights: Tuple[float, float, float, float],
    device: torch.device,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """§6.4 base score and runtime estimates for the masked candidate set:
    each weighted term a rounded product, summed in the NumPy engine's
    order (``t_kw (+ t_bal) + t_pr + t_sk``); the sparse locality and
    size-match adjustments stay host-side in the caller. One upload and one
    download. Returns (scores, est, scaled)."""
    w_kw, w_bal, w_pr, w_sk = (_scalar(w, device) for w in weights)
    has_bal = bal is not None
    cols = [kvec, prio, skips, flop, pf] + ([bal] if has_bal else [])
    x = _up(np.stack([np.asarray(c, dtype=np.float64) for c in cols]), device, F64)
    kv, pr, sk, fl, pfs = x[0], x[1], x[2], x[3], x[4]
    scores = w_kw * kv
    if has_bal:
        scores = scores + w_bal * x[5]
    scores = scores + w_pr * pr
    scores = scores + w_sk * torch.minimum(sk, _scalar(5.0, device))
    inf = _scalar(np.inf, device)
    est = torch.where(pfs > 0.0, fl / pfs, inf)
    if avail <= 0:
        scaled = torch.full_like(est, np.inf)
    else:
        scaled = est / _scalar(avail, device)
    out = _down(torch.stack([scores, est, scaled]))
    return out[0], out[1], out[2]


# ----------------------------------------------------------------------
# client engine (core/batch_client greedy passes)
# ----------------------------------------------------------------------


def run_set_greedy(
    live_s: np.ndarray,
    cu_s: np.ndarray,
    wss_s: np.ndarray,
    gpu_s: np.ndarray,
    nci_s: np.ndarray,
    u_s: Dict,
    has: Dict,
    nins: Dict,
    ram0: np.ndarray,
    rhs1: np.ndarray,
    rhs2: np.ndarray,
    device: torch.device,
) -> np.ndarray:
    """``BatchClientEngine._run_set_pass``'s greedy rank loop on the device:
    one Python step a rank, a vector op across hosts at each.

    ``u_s``/``has``/``nins`` are keyed by the non-CPU resource types in the
    snapshot's iteration order (the order the NumPy loop visits them).
    ``ram0`` is the host-side ``ram * ram_frac`` product, rounded before it
    meets the RAM subtractions. A rank with no live host changes nothing
    and is skipped, as the NumPy loop skips it. Returns the chosen [J, H]
    mask."""
    J, H = live_s.shape
    rts = list(u_s)
    R = len(rts)
    fl = _up(np.stack([cu_s, wss_s] + [u_s[rt] for rt in rts]), device, F64)
    cu, wss, u = fl[0], fl[1], fl[2:]
    bl = _up(np.stack([live_s, gpu_s, nci_s]), device, torch.bool)
    live, gpu, nci = bl[0], bl[1], bl[2]
    vec = _up(np.stack([ram0, rhs1, rhs2] + [nins[rt] for rt in rts]), device, F64)
    ram_left, r1, r2 = vec[0], vec[1], vec[2]
    cap = [vec[3 + i] for i in range(R)]
    has_t = _up(np.stack([has[rt] for rt in rts]), device, torch.bool) if R else None
    cpu_cpu = torch.zeros(H, dtype=F64, device=device)
    cpu_all = torch.zeros(H, dtype=F64, device=device)
    chosen = torch.zeros((J, H), dtype=torch.bool, device=device)
    for r in np.flatnonzero(live_s.any(axis=1)).tolist():
        lv, cu_r, gpu_r = live[r], cu[r], gpu[r]
        feas = lv
        for i in range(R):
            ur = u[i, r]
            # u > 0 gate: the scalar loop only visits usage keys the job carries
            feas = feas & ~((cap[i] < ur - 1e-12) & (ur > 0.0))
        feas = feas & ~(~gpu_r & ((cpu_cpu + cu_r) > r1))
        feas = feas & ((cpu_all + cu_r) <= r2)
        feas = feas & (wss[r] <= ram_left)
        feas = feas | (nci[r] & lv)  # §3.5: always run
        chosen[r] = feas
        for i in range(R):
            cap[i] = torch.where(feas & has_t[i], cap[i] - u[i, r], cap[i])
        cpu_cpu = torch.where(feas & ~gpu_r, cpu_cpu + cu_r, cpu_cpu)
        cpu_all = torch.where(feas, cpu_all + cu_r, cpu_all)
        ram_left = torch.where(feas, ram_left - wss[r], ram_left)
    return _down(chosen)


def _all_plus_zero(a: np.ndarray, axis: int) -> np.ndarray:
    """Where every entry along ``axis`` is +0.0 (not -0.0): subtracting such
    a row changes no value's bits, NaN and -0.0 included."""
    return ((a == 0.0) & ~np.signbit(a)).all(axis=axis)


class WRRGreedyContext:
    """Device-resident WRR inputs for one ``_wrr_raw`` call: the static
    per-event arrays (usage, thresholds, caps, RAM) are uploaded once and
    each event's greedy pass runs over them.

    A rank runs only the ops that can change its result, decided once per
    call from the host arrays:

      * the resource test ``(cap >= u - eps) | (u <= 0)`` runs as
        ``cap >= t`` with ``t = -inf`` where ``u <= 0``, when every usage and
        cap is finite and small enough that no cap can reach NaN (then
        ``cap >= -inf`` is True, as the ``|`` makes it); otherwise as two
        ops; not at all where every lane of the rank has ``u <= 0``;
      * the ``has`` mask only where some host lacks the resource;
      * a cap or RAM subtraction not where the rank's row is all +0.0
        (``x - (+0.0)`` is ``x``, bit for bit, NaN and -0.0 included);
      * the RAM test not where the rank's working sets are all +0.0 and no
        host's RAM is negative or NaN (then ``0 <= ram_left`` holds
        throughout: RAM is only ever reduced by a working set it covers).

    Every op writes into a buffer made once a pass (``out=``), and the rows
    are views made once (``unbind``), so a rank allocates nothing."""

    def __init__(self, s, u_w: Dict, u_eps: Dict, u_zero: Dict, wss_w: np.ndarray,
                 device: torch.device) -> None:
        self.device = device
        self.J, self.H = s.J, s.H
        self.rtypes = list(s.rtypes)
        rts = self.rtypes
        u = np.stack([u_w[rt] for rt in rts])
        ueps = np.stack([u_eps[rt] for rt in rts])
        uzero = np.stack([u_zero[rt] for rt in rts])
        nins = np.stack([s.nins[rt] for rt in rts])
        # caps start at nins and lose at most J usages: bounded, they stay finite
        bound = np.abs(nins).max(initial=0.0) + self.J * np.abs(u).max(initial=0.0)
        self._fold_zero = bool(np.isfinite(u).all() and np.isfinite(nins).all() and bound < 1e300)
        if self._fold_zero:
            ueps = np.where(uzero, -np.inf, ueps)
        self._u = _up(u, device, F64)
        self._ueps = _up(ueps, device, F64)
        self._uzero = _up(uzero, device, torch.bool)
        self._has = _up(np.stack([s.has[rt] for rt in rts]), device, torch.bool)
        self._nins = _up(nins, device, F64)
        self._wss = _up(wss_w, device, F64)
        self._ram = _up(s.ram, device, F64)
        self._rows = {name: [t.unbind(0) for t in getattr(self, name)]
                      for name in ("_u", "_ueps", "_uzero")}
        self._wss_rows = self._wss.unbind(0)
        self._has_rows = self._has.unbind(0)
        # host-side facts, (R, J) or (J,): which ops a rank needs
        self._has_all = [bool(s.all_has[rt]) for rt in rts]
        self._zero_all = uzero.all(axis=2)
        self._zero_any = uzero.any(axis=2) & (not self._fold_zero)
        self._u_zero_row = _all_plus_zero(u, axis=2)
        ram_ok = bool(np.all(s.ram >= 0.0))
        self._wss_zero_row = (_all_plus_zero(wss_w, axis=1) if ram_ok
                              else np.zeros(self.J, dtype=bool))

    def greedy(self, order_live: np.ndarray, active: np.ndarray,
               row_counts: Optional[np.ndarray] = None):
        """One greedy maximal-set pass in WRR order; returns (running [J, H],
        caps dict). A rank with no live candidate (``row_counts[k] == 0``,
        the event loop's count) changes nothing and is skipped, as the
        NumPy pass skips it. One upload and one download."""
        dev = self.device
        J, H, R = self.J, self.H, len(self.rtypes)
        x = _up(np.concatenate([order_live, active[None, :]]), dev, torch.bool)
        olact = (x[:-1] & x[-1]).unbind(0)
        cap_all = self._nins.clone()
        cap = cap_all.unbind(0)
        ram_left = self._ram.clone()
        running = torch.zeros((J, H), dtype=torch.bool, device=dev)
        rows = running.unbind(0)
        ok = torch.empty(H, dtype=torch.bool, device=dev)
        sel = torch.empty(H, dtype=torch.bool, device=dev)
        tmp = torch.empty(H, dtype=F64, device=dev)
        u_rows, ueps_rows, uzero_rows = (self._rows[n] for n in ("_u", "_ueps", "_uzero"))
        ranks = range(J) if row_counts is None else np.flatnonzero(row_counts).tolist()
        for k in ranks:
            feas = rows[k]
            first = True
            for i in range(R):
                if self._zero_all[i, k]:
                    continue  # (cap >= u - eps) | True
                torch.ge(cap[i], ueps_rows[i][k], out=ok)
                if self._zero_any[i, k]:
                    ok.logical_or_(uzero_rows[i][k])
                if first:
                    torch.logical_and(olact[k], ok, out=feas)
                    first = False
                else:
                    feas.logical_and_(ok)
            if first:
                feas.copy_(olact[k])
            if not self._wss_zero_row[k]:
                torch.le(self._wss_rows[k], ram_left, out=ok)
                feas.logical_and_(ok)
            for i in range(R):
                if self._u_zero_row[i, k]:
                    continue
                mask = feas
                if not self._has_all[i]:
                    mask = torch.logical_and(feas, self._has_rows[i], out=sel)
                torch.sub(cap[i], u_rows[i][k], out=tmp)
                torch.where(mask, tmp, cap[i], out=cap[i])
            if not self._wss_zero_row[k]:
                torch.sub(ram_left, self._wss_rows[k], out=tmp)
                torch.where(feas, tmp, ram_left, out=ram_left)
        out = _down(torch.cat([running.to(F64), cap_all]))
        caps = out[J:]
        return out[:J] != 0.0, {rt: caps[i].copy() for i, rt in enumerate(self.rtypes)}


# ----------------------------------------------------------------------
# world device mirror (core/world.HostArrays, backend="torch")
# ----------------------------------------------------------------------


class WorldDeviceMirror:
    """Device-resident mirrors of the accrual-relevant ``HostArrays``
    columns, with a dirty-range upload contract.

    Upload direction (host → device): mutation hooks mark the touched dense
    slot (``HostArrays._touch``); before each device pass only the dirty
    slots' columns are re-uploaded, in place (``index_copy_``). Array growth
    or compaction reallocates host storage, so a shape change forces a full
    re-upload. Compute direction: the accrual pass updates
    ``q_runtime``/``q_frac``/``busy`` on the device in place and writes the
    touched slice back to the host arrays, so host and device stay equal
    after every pass.
    """

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self._shape: Optional[Tuple[int, int]] = None
        self.all_dirty = True
        self.dirty: set = set()
        self.q_total = None
        self.q_runtime = None
        self.q_frac = None
        self.q_running = None
        self.q_weight = None
        self.q_cpu = None
        self.busy = None

    # -- upload ---------------------------------------------------------

    def mark(self, slot: int) -> None:
        self.dirty.add(slot)

    def _host_columns(self, world):
        from .types import ResourceType

        return (world.q_total, world.q_runtime, world.q_frac, world.q_weight,
                world.q_usage[ResourceType.CPU])

    def sync(self, world) -> None:
        """Apply the dirty-range upload contract against ``world``."""
        dev = self.device
        q_total, q_runtime, q_frac, q_weight, q_cpu = self._host_columns(world)
        shape = q_cpu.shape
        if self._shape != shape or self.all_dirty:
            f = _up(np.stack([q_total, q_runtime, q_frac, q_weight, q_cpu]), dev, F64)
            self.q_total, self.q_runtime, self.q_frac, self.q_weight, self.q_cpu = f.unbind(0)
            self.q_running = _up(world.q_running, dev, torch.bool)
            self.busy = _up(world.busy, dev, F64)
            self._shape = shape
            self.all_dirty = False
            self.dirty.clear()
            return
        if not self.dirty:
            return
        cols = np.fromiter(sorted(self.dirty), np.int64, len(self.dirty))
        idx = _up(cols, dev)
        f = _up(np.stack([q_total[:, cols], q_runtime[:, cols], q_frac[:, cols],
                          q_weight[:, cols], q_cpu[:, cols]]), dev, F64)
        for col, new in zip((self.q_total, self.q_runtime, self.q_frac, self.q_weight,
                             self.q_cpu), f.unbind(0)):
            col.index_copy_(1, idx, new)
        self.q_running.index_copy_(1, idx, _up(world.q_running[:, cols], dev, torch.bool))
        self.busy.index_copy_(0, idx, _up(world.busy[cols], dev, F64))
        self.dirty.clear()

    # -- compute --------------------------------------------------------

    def advance(self, world, sub: np.ndarray, dts: np.ndarray):
        """Device accrual pass over the active host slots ``sub``; returns
        the per-slot REC debit totals and the touched mask, after writing
        the updated runtime/fraction/busy columns back to ``world``.

        The clamped accrual is elementwise over the occupied depth K (rows
        past it hold no running job for these slots); the busy and debit
        charges are rounded products folded row by row in queue-row order,
        as the NumPy K-loop adds them."""
        self.sync(world)
        dev = self.device
        K = int(world.q_count[sub].max())
        idx = _up(sub, dev, torch.int64)
        d = _up(dts, dev, F64)
        tot = self.q_total[:K].index_select(1, idx)
        run = self.q_runtime[:K].index_select(1, idx)
        frac = self.q_frac[:K].index_select(1, idx)
        m = self.q_running[:K].index_select(1, idx)
        zero = _scalar(0.0, dev)
        rem = tot - run
        rem = torch.where(rem < 0.0, zero, rem)
        d2 = d.expand(K, -1)
        eff = torch.where(d2 < rem, d2, rem)
        eff = torch.where(m, eff, zero)
        run2 = torch.where(m, run + eff, run)
        denom = torch.where(tot > 1e-9, tot, _scalar(1e-9, dev))
        fr = run2 / denom
        fr = torch.where(fr > 1.0, _scalar(1.0, dev), fr)
        frac2 = torch.where(m, fr, frac)
        # the charge products, each rounded before the folds below add it
        binc = eff * self.q_cpu[:K].index_select(1, idx)
        winc = eff * self.q_weight[:K].index_select(1, idx)
        busy_sub = self.busy.index_select(0, idx)
        debit = torch.zeros(len(sub), dtype=F64, device=dev)
        for k in range(K):
            busy_sub = torch.where(m[k], busy_sub + binc[k], busy_sub)
            debit = torch.where(m[k], debit + winc[k], debit)
        self.q_runtime[:K].index_copy_(1, idx, run2)
        self.q_frac[:K].index_copy_(1, idx, frac2)
        self.busy.index_copy_(0, idx, busy_sub)

        rf = _down(torch.stack([run2, frac2]))
        bd = _down(torch.stack([busy_sub, debit]))
        touched = _down(m.any(dim=0))
        world.q_runtime[:K, sub] = rf[0]
        world.q_frac[:K, sub] = rf[1]
        world.busy[sub] = bd[0]
        return bd[1], touched

    def completed_mask(self, world, idx: np.ndarray, counts: np.ndarray) -> np.ndarray:
        """Completion mask over the device accrual matrix for slots ``idx``,
        rows ``[0, max(counts))``, each host's rows past its queue count
        masked out; downloaded as bool."""
        self.sync(world)
        dev = self.device
        K = int(counts.max())
        ii = _up(idx, dev, torch.int64)
        c = _up(counts, dev, torch.int64)
        m = self.q_running[:K].index_select(1, ii)
        run = self.q_runtime[:K].index_select(1, ii)
        tot = self.q_total[:K].index_select(1, ii)
        rowmask = torch.arange(K, device=dev)[:, None] < c[None, :]
        return _down(m & (run >= tot - 1e-6) & rowmask)


# ----------------------------------------------------------------------
# quorum_compare digest routing (core/batch_validate, backend="torch")
# ----------------------------------------------------------------------


# the most verdicts one panel of a digest call holds on the card: 64 MiB of
# int32 counts; a panel takes as many rows as fit beside all n columns
PANEL_ENTRIES = 1 << 24


def quorum_group_codes(mat: np.ndarray, rtol: float, atol: float,
                       device: torch.device) -> np.ndarray:
    """Group codes for a homogeneous (n, d) float payload matrix through the
    ``quorum_compare`` pair-count kernel (its plain version on the CPU).

    The matrix is cast to f32 on the device, as the reference's Pallas
    wrapper casts it. Greedy first-match grouping: row i joins the first
    group whose representative it agrees with (``n_bad == 0`` under the
    comparator's tolerances, the representative as ``b``), else it founds a
    new group. Under the digest contract (replicas either agree well within
    tolerance or disagree far outside it) this partition equals the scalar
    comparator's greedy pairwise grouping. NaN-carrying rows match nothing
    (the kernel counts a NaN as no disagreement) and get unique sentinels in
    row order, as the reference's ``quorum_group_codes`` gives them.

    Every earlier-row count of a panel of rows comes from one launch and
    one copy to the host; the greedy then reads them there, so the codes are
    those of comparing each row with each representative in turn."""
    from ..kernels.quorum_compare.ops import quorum_pair_counts
    from .validator import _nan_sentinel

    rows = _up(mat, device).to(torch.float32)
    n = mat.shape[0]
    codes = np.zeros(n, dtype=np.int64)
    reps = np.zeros(n, dtype=np.int64)  # representatives, in founding order
    n_reps = 0
    nan_rows = np.isnan(mat).any(axis=1)
    step = max(1, PANEL_ENTRIES // max(n, 1))
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        agree = quorum_pair_counts(rows, lo, hi, rtol=rtol, atol=atol).cpu().numpy() == 0
        for i in range(lo, hi):
            if nan_rows[i]:
                codes[i] = _nan_sentinel()
                continue
            hit = agree[i - lo, reps[:n_reps]]
            g = int(hit.argmax()) if n_reps else 0
            if n_reps and hit[g]:
                codes[i] = g
            else:
                reps[n_reps] = i
                codes[i] = n_reps
                n_reps += 1
    return codes


def fuzzy_digest_torch(base, rtol: float, atol: float, device: torch.device):
    """Wrap a fuzzy comparator's digest hook: homogeneous float tensor
    payload batches route through the ``quorum_compare`` grouping on
    ``device``; everything else (plain floats, mixed payloads) goes to
    ``base``, the NumPy digest, as in the reference."""
    from .validator import _homogeneous_arrays

    def fn(outputs: Sequence) -> np.ndarray:
        if len(outputs) >= 2 and isinstance(outputs[0], np.ndarray):
            mat = _homogeneous_arrays(outputs)
            if mat is not None and mat.dtype.kind == "f":
                return quorum_group_codes(mat, rtol, atol, device)
        return base(outputs)

    return fn
