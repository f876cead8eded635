"""Batched affine-gap local/semi-global DP extension (XLA scan).

Replaces the reference's 32-lane AVX2 kernel
(/root/reference/soap4/CPU_DP.cpp GenerateDPTable) with a batch-first
formulation: candidates (read window x reference window) are scanned
over read positions; each step is elementwise work on a (batch,
ref_window) slab plus one prefix-max along the window axis. XLA
compiles the scan for every backend; there is no hand-written kernel.

Scoring contract (soap4-nt2.ini [DP], CPU_DP.cpp:119-120): match=+1
(fixed), mismatch=-2, gap open=-3 (cost of the FIRST gap base), gap
extend=-1 per further base. With the reference's clip caps (130 >= read
length, soap4.ini [Clipping]) its "semi-global with soft clips" DP is
exactly affine local alignment; hits are kept when
score >= max(cutoff_ratio*len, threshold) per end
(DV-DPfunctions.cpp:3439-3440, definitions.h:166-167).

Key algebraic step: within one read column, the vertical gap chain
E[i] = max(E[i-1]+ge, H[i-1]+go) may use H *without* its E term because
go < ge makes re-opening from a gap cell never optimal; E then becomes
a prefix-max of (H_noE[i] + go - i*ge), removing the in-column
sequential dependency.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

NEG = -(10**6)  # -inf surrogate that survives int32 adds


class DPParams(NamedTuple):
    match: int = 1
    mismatch: int = -2
    gap_open: int = -3  # first gap base
    gap_extend: int = -1


class DPResult(NamedTuple):
    score: jnp.ndarray  # int32 [B] best local score
    end_ref: jnp.ndarray  # int32 [B] ref index AFTER the last aligned base
    end_read: jnp.ndarray  # int32 [B] read index AFTER the last aligned base


@functools.partial(jax.jit, static_argnames=("params",))
def sw_align(
    reads: jnp.ndarray,  # uint8/int32 [B, R] read codes
    refs: jnp.ndarray,  # uint8/int32 [B, W] ref window codes
    read_lens: jnp.ndarray,  # int32 [B]
    ref_lens: jnp.ndarray,  # int32 [B]
    params: DPParams = DPParams(),
) -> DPResult:
    """Batched affine-gap local alignment: score + end cell per candidate."""
    B, R = reads.shape
    W = refs.shape[1]
    match = jnp.int32(params.match)
    mm = jnp.int32(params.mismatch)
    go = jnp.int32(params.gap_open)
    ge = jnp.int32(params.gap_extend)

    refs = refs.astype(jnp.int32)
    reads = reads.astype(jnp.int32)
    row_idx = jnp.arange(W, dtype=jnp.int32)[None, :]  # (1, W)
    row_valid = row_idx < ref_lens[:, None]  # (B, W)
    # decay-compensation term for the prefix-max trick
    decay = row_idx * ge  # (1, W) broadcast

    def step(carry, j):
        H_prev, F_prev, best, best_i, best_j = carry
        read_c = jax.lax.dynamic_slice_in_dim(reads, j, 1, axis=1)  # (B,1)
        sub = jnp.where(refs == read_c, match, mm)  # (B, W)

        # F: gap in ref (consume read), elementwise from previous column
        F = jnp.maximum(H_prev + go, F_prev + ge)
        # M: diagonal from previous column shifted down one ref row
        H_shift = jnp.pad(H_prev[:, :-1], ((0, 0), (1, 0)))
        M = H_shift + sub
        H_noE = jnp.maximum(jnp.maximum(M, F), 0)
        # E: gap in read (consume ref) via prefix-max along the window:
        # E[w] = max_{w'<w} H_noE[w'] + go + (w-1-w')*ge
        Y = H_noE + go - decay  # (B, W)
        Ycum = jax.lax.cummax(Y, axis=1)
        Yshift = jnp.pad(Ycum[:, :-1], ((0, 0), (1, 0)), constant_values=NEG)
        E = Yshift + decay - ge
        H = jnp.maximum(H_noE, E)

        col_valid = j < read_lens  # (B,)
        Hv = jnp.where(row_valid & col_valid[:, None], H, 0)
        col_best = jnp.max(Hv, axis=1)
        col_arg = jnp.argmax(Hv, axis=1).astype(jnp.int32)
        better = col_best > best
        best = jnp.where(better, col_best, best)
        best_i = jnp.where(better, col_arg + 1, best_i)
        best_j = jnp.where(better, j + 1, best_j)

        H = jnp.where(col_valid[:, None], H, H_prev)
        F = jnp.where(col_valid[:, None], F, F_prev)
        return (H, F, best, best_i, best_j), None

    H0 = jnp.zeros((B, W), dtype=jnp.int32)
    F0 = jnp.full((B, W), NEG, dtype=jnp.int32)
    z = jnp.zeros(B, dtype=jnp.int32)
    (H, F, best, best_i, best_j), _ = jax.lax.scan(
        step, (H0, F0, z, z, z), jnp.arange(R, dtype=jnp.int32)
    )
    return DPResult(score=best, end_ref=best_i, end_read=best_j)


@functools.partial(jax.jit, static_argnames=("params", "n_codes"))
def sw_align_substmat(
    reads: jnp.ndarray,  # uint8 [B, R] query codes (alphabet < n_codes)
    refs: jnp.ndarray,  # uint8 [B, W] subject window codes
    read_lens: jnp.ndarray,  # int32 [B]
    ref_lens: jnp.ndarray,  # int32 [B]
    subst: jnp.ndarray,  # int32 [n_codes, n_codes] substitution matrix
    params: DPParams = DPParams(),
    n_codes: int = 24,
) -> DPResult:
    """Batched affine-gap local alignment under an arbitrary
    substitution matrix (BLOSUM62 for the translated protein path).

    Same scan/prefix-max structure as ``sw_align``; the per-column
    substitution row is fetched as a tiny one-hot matmul over the
    query code and expanded over the subject with an n_codes-way
    masked int32 contraction instead of a 2-D table gather.
    """
    B, R = reads.shape
    W = refs.shape[1]
    go = jnp.int32(params.gap_open)
    ge = jnp.int32(params.gap_extend)

    refs_i = refs.astype(jnp.int32)
    reads_i = reads.astype(jnp.int32)
    codes = jnp.arange(n_codes, dtype=jnp.int32)
    # subject one-hot expansion, once per call: (n_codes, B, W) int8
    refs_oh = (refs_i[None, :, :] == codes[:, None, None]).astype(jnp.int32)
    row_idx = jnp.arange(W, dtype=jnp.int32)[None, :]
    row_valid = row_idx < ref_lens[:, None]
    decay = row_idx * ge

    def step(carry, j):
        H_prev, F_prev, best, best_i, best_j = carry
        read_c = jax.lax.dynamic_slice_in_dim(reads_i, j, 1, axis=1)[:, 0]
        rowtab = jnp.sum(
            jnp.where(
                codes[None, :] == read_c[:, None], 1, 0
            )[:, :, None]
            * subst[None, :, :],
            axis=1,
        )  # (B, n_codes)
        sub = jnp.einsum("abw,ba->bw", refs_oh, rowtab)  # (B, W)

        F = jnp.maximum(H_prev + go, F_prev + ge)
        H_shift = jnp.pad(H_prev[:, :-1], ((0, 0), (1, 0)))
        M = H_shift + sub
        H_noE = jnp.maximum(jnp.maximum(M, F), 0)
        Y = H_noE + go - decay
        Ycum = jax.lax.cummax(Y, axis=1)
        Yshift = jnp.pad(Ycum[:, :-1], ((0, 0), (1, 0)), constant_values=NEG)
        E = Yshift + decay - ge
        H = jnp.maximum(H_noE, E)

        col_valid = j < read_lens
        Hv = jnp.where(row_valid & col_valid[:, None], H, 0)
        col_best = jnp.max(Hv, axis=1)
        col_arg = jnp.argmax(Hv, axis=1).astype(jnp.int32)
        better = col_best > best
        best = jnp.where(better, col_best, best)
        best_i = jnp.where(better, col_arg + 1, best_i)
        best_j = jnp.where(better, j + 1, best_j)

        H = jnp.where(col_valid[:, None], H, H_prev)
        F = jnp.where(col_valid[:, None], F, F_prev)
        return (H, F, best, best_i, best_j), None

    H0 = jnp.zeros((B, W), dtype=jnp.int32)
    F0 = jnp.full((B, W), NEG, dtype=jnp.int32)
    z = jnp.zeros(B, dtype=jnp.int32)
    (H, F, best, best_i, best_j), _ = jax.lax.scan(
        step, (H0, F0, z, z, z), jnp.arange(R, dtype=jnp.int32)
    )
    return DPResult(score=best, end_ref=best_i, end_read=best_j)


def sw_align_protein(
    reads: jnp.ndarray,
    refs: jnp.ndarray,
    read_lens: jnp.ndarray,
    ref_lens: jnp.ndarray,
    params: DPParams = DPParams(match=0, mismatch=0, gap_open=-11,
                                gap_extend=-1),
) -> DPResult:
    """BLOSUM62 local alignment (the AC-DIAMOND blastx scoring)."""
    from megapath.classify.protein import BLOSUM62, N_AA

    return sw_align_substmat(
        reads, refs, read_lens, ref_lens, jnp.asarray(BLOSUM62),
        params=params, n_codes=N_AA,
    )


# ---------------------------------------------------------------------------
# Oracle + traceback (host-side, for tests and CIGAR of reported hits)
# ---------------------------------------------------------------------------


def sw_align_oracle(
    read: np.ndarray, ref: np.ndarray, params: DPParams = DPParams()
) -> Tuple[int, int, int]:
    """O(R*W) scalar reference. Returns (score, end_ref, end_read) with
    first-encountered-max tie-breaking in (j, i) scan order."""
    R, W = len(read), len(ref)
    H = np.zeros((W + 1, R + 1), dtype=np.int64)
    E = np.full((W + 1, R + 1), NEG, dtype=np.int64)
    F = np.full((W + 1, R + 1), NEG, dtype=np.int64)
    best, bi, bj = 0, 0, 0
    for j in range(1, R + 1):
        for i in range(1, W + 1):
            E[i, j] = max(E[i - 1, j] + params.gap_extend, H[i - 1, j] + params.gap_open)
            F[i, j] = max(F[i, j - 1] + params.gap_extend, H[i, j - 1] + params.gap_open)
            s = params.match if read[j - 1] == ref[i - 1] else params.mismatch
            H[i, j] = max(0, H[i - 1, j - 1] + s, E[i, j], F[i, j])
            if H[i, j] > best:
                best, bi, bj = int(H[i, j]), i, j
    return best, bi, bj


def sw_traceback(
    read: np.ndarray, ref: np.ndarray, end_ref: int, end_read: int,
    params: DPParams = DPParams(),
) -> Tuple[int, int, str, int]:
    """Recompute the DP up to the end cell and trace back.

    Returns (start_ref, start_read, cigar, edit_distance) where cigar
    covers read[start_read:end_read] with soft clips added by callers.
    Host-side: runs only on reported hits (a tiny fraction of DP work).
    """
    i, j, ops = sw_traceback_ops(read, ref, end_ref, end_read, params)
    cigar = _runlength(ops)
    edit = sum(1 for o in ops if o in "XID")
    return i, j, cigar, edit


def sw_traceback_ops(
    read: np.ndarray, ref: np.ndarray, end_ref: int, end_read: int,
    params: DPParams = DPParams(),
) -> Tuple[int, int, list]:
    """Like sw_traceback but returns the raw per-cell op list
    (M/X/I/D, mismatches NOT folded into M) — variant extraction
    needs the distinction."""
    R, W = int(end_read), int(end_ref)
    read = np.asarray(read[:R], dtype=np.int64)
    ref = np.asarray(ref[:W], dtype=np.int64)
    H = np.zeros((W + 1, R + 1), dtype=np.int64)
    E = np.full((W + 1, R + 1), NEG, dtype=np.int64)
    F = np.full((W + 1, R + 1), NEG, dtype=np.int64)
    for j in range(1, R + 1):
        sub = np.where(ref == read[j - 1], params.match, params.mismatch)
        for i in range(1, W + 1):
            E[i, j] = max(E[i - 1, j] + params.gap_extend, H[i - 1, j] + params.gap_open)
            F[i, j] = max(F[i, j - 1] + params.gap_extend, H[i, j - 1] + params.gap_open)
            H[i, j] = max(0, H[i - 1, j - 1] + sub[i - 1], E[i, j], F[i, j])
    i, j = W, R
    ops: list = []
    state = "H"
    while i > 0 and j > 0 and not (state == "H" and H[i, j] == 0):
        if state == "H":
            s = params.match if read[j - 1] == ref[i - 1] else params.mismatch
            if H[i, j] == H[i - 1, j - 1] + s:
                ops.append("M" if read[j - 1] == ref[i - 1] else "X")
                i, j = i - 1, j - 1
            elif H[i, j] == E[i, j]:
                state = "E"
            else:
                state = "F"
        elif state == "E":  # deletion from read (ref consumed)
            ops.append("D")
            if E[i, j] == H[i - 1, j] + params.gap_open:
                state = "H"
            i -= 1
        else:  # F: insertion to read (read consumed)
            ops.append("I")
            if F[i, j] == H[i, j - 1] + params.gap_open:
                state = "H"
            j -= 1
    ops.reverse()
    return i, j, ops


def sw_traceback_batch(
    reads: np.ndarray,  # uint8 [B, R] oriented read codes
    windows: np.ndarray,  # uint8 [B, W] ref window codes
    end_ref: np.ndarray,  # int [B] traceback start (ref cells used)
    end_read: np.ndarray,  # int [B]
    params: DPParams = DPParams(),
    chunk_bytes: int = 256 << 20,
) -> Tuple[np.ndarray, np.ndarray, list, np.ndarray]:
    """Batched ``sw_traceback`` over all hits at once.

    The per-hit Python double loop (O(W*R) cells each) is replaced by
    a fill vectorized over (hits, window) — one pass over read columns
    using the same prefix-max E decoupling as the device kernel — that
    stores a per-cell direction byte, then a lockstep vectorized
    traceback walks every hit simultaneously. Decisions compare the
    same values in the same priority order as ``sw_traceback_ops``, so
    the per-hit (start_ref, start_read, cigar, edit) are identical.

    Returns (start_ref [B], start_read [B], cigars list[str],
    edit_distances [B]).
    """
    B, R = reads.shape
    W = windows.shape[1]
    out_sr = np.zeros(B, np.int64)
    out_sj = np.zeros(B, np.int64)
    out_cigars: list = [""] * B
    out_edit = np.zeros(B, np.int64)
    if B == 0:
        return out_sr, out_sj, out_cigars, out_edit
    cb = max(1, int(chunk_bytes // max(W * R, 1)))
    for lo in range(0, B, cb):
        hi = min(lo + cb, B)
        sr, sj, cigs, ed = _traceback_chunk(
            reads[lo:hi], windows[lo:hi],
            np.asarray(end_ref[lo:hi], np.int64),
            np.asarray(end_read[lo:hi], np.int64), params,
        )
        out_sr[lo:hi] = sr
        out_sj[lo:hi] = sj
        out_cigars[lo:hi] = cigs
        out_edit[lo:hi] = ed
    return out_sr, out_sj, out_cigars, out_edit


def _traceback_chunk(reads, windows, end_ref, end_read, params):
    B, R = reads.shape
    W = windows.shape[1]
    match = np.int64(params.match)
    mm = np.int64(params.mismatch)
    go = np.int64(params.gap_open)
    ge = np.int64(params.gap_extend)
    reads_i = reads.astype(np.int64)
    wins_i = windows.astype(np.int64)
    decay = np.arange(W, dtype=np.int64)[None, :] * ge

    # direction plane: bits 0-1 H source (0 stop, 1 diag, 2 E, 3 F),
    # bit 2 E-open (E == H[i-1,j] + go), bit 3 F-open
    dirp = np.zeros((B, W, R), np.uint8)
    H_prev = np.zeros((B, W), np.int64)
    F_prev = np.full((B, W), NEG, np.int64)
    for j in range(1, R + 1):
        sub = np.where(wins_i == reads_i[:, j - 1 : j], match, mm)
        F = np.maximum(H_prev + go, F_prev + ge)
        fopen = F == H_prev + go
        diag = np.concatenate(
            [np.zeros((B, 1), np.int64), H_prev[:, :-1]], axis=1
        ) + sub
        H_noE = np.maximum(np.maximum(diag, F), 0)
        # E[i] = max_{k<i} H_noE[k] + go + (i-1-k)*ge  (prefix max;
        # opening from an E-valued cell is never optimal for go <= ge,
        # so values equal the oracle's H-or-E chain exactly)
        Y = H_noE + go - decay
        Ycum = np.maximum.accumulate(Y, axis=1)
        E = np.concatenate(
            [np.full((B, 1), NEG, np.int64), Ycum[:, :-1]], axis=1
        ) + decay - ge
        H = np.maximum(H_noE, E)
        eopen = E == np.concatenate(
            [np.zeros((B, 1), np.int64), H[:, :-1]], axis=1
        ) + go
        code = np.where(
            H == 0,
            0,
            np.where(H == diag, 1, np.where(H == E, 2, 3)),
        ).astype(np.uint8)
        dirp[:, :, j - 1] = (
            code | (eopen.astype(np.uint8) << 2)
            | (fopen.astype(np.uint8) << 3)
        )
        H_prev, F_prev = H, F

    # lockstep traceback (state machine identical to sw_traceback_ops)
    i = end_ref.copy()
    j = end_read.copy()
    state = np.zeros(B, np.uint8)  # 0=H, 1=E, 2=F
    T = 2 * (W + R) + 4
    ops_buf = np.zeros((B, T), np.uint8)  # back-to-front; 1M 2X 3I 4D
    n_ops = np.zeros(B, np.int64)
    bidx = np.arange(B)
    active = (i > 0) & (j > 0)
    for _ in range(T):
        if not active.any():
            break
        d = np.zeros(B, np.uint8)
        d[active] = dirp[bidx[active], i[active] - 1, j[active] - 1]
        code = d & 3
        # H state
        mH = active & (state == 0)
        stop = mH & (code == 0)
        active = active & ~stop
        mH = mH & ~stop
        mdiag = mH & (code == 1)
        if mdiag.any():
            is_m = (
                reads_i[bidx[mdiag], j[mdiag] - 1]
                == wins_i[bidx[mdiag], i[mdiag] - 1]
            )
            ops_buf[bidx[mdiag], n_ops[mdiag]] = np.where(is_m, 1, 2)
            n_ops[mdiag] += 1
            i[mdiag] -= 1
            j[mdiag] -= 1
        state[mH & (code == 2)] = 1
        state[mH & (code == 3)] = 2
        # E state: append D, maybe close, consume ref
        mE = active & (state == 1)
        if mE.any():
            ops_buf[bidx[mE], n_ops[mE]] = 4
            n_ops[mE] += 1
            close = mE & ((d >> 2) & 1 == 1)
            state[close] = 0
            i[mE] -= 1
        # F state: append I, maybe close, consume read
        mF = active & (state == 2)
        if mF.any():
            ops_buf[bidx[mF], n_ops[mF]] = 3
            n_ops[mF] += 1
            close = mF & ((d >> 3) & 1 == 1)
            state[close] = 0
            j[mF] -= 1
        active = active & (i > 0) & (j > 0)

    # per-hit run-length encode (X folds into M for the CIGAR text,
    # counts as edit distance); ops were emitted back-to-front
    edit = ((ops_buf >= 2) & (ops_buf <= 4)).sum(axis=1)
    sym_of = np.array(["", "M", "M", "I", "D"])
    cigars = []
    for b in range(B):
        k = int(n_ops[b])
        if k == 0:
            cigars.append("")
            continue
        seq = ops_buf[b, :k][::-1]
        sym = np.where(seq == 2, 1, seq)
        bounds = np.flatnonzero(np.r_[True, sym[1:] != sym[:-1]])
        counts = np.diff(np.r_[bounds, k])
        cigars.append(
            "".join(
                f"{c}{sym_of[sym[p]]}" for p, c in zip(bounds, counts)
            )
        )
    return i, j, cigars, edit


def _runlength(ops: list) -> str:
    out = []
    for o in ops:
        sym = "M" if o in ("M", "X") else o
        if out and out[-1][1] == sym:
            out[-1][0] += 1
        else:
            out.append([1, sym])
    return "".join(f"{n}{s}" for n, s in out)
