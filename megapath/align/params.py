"""Alignment engine configuration.

Typed equivalents of soap4's ini/CLI parameter soup
(/root/reference/soap4/IniParam.cpp, soap4-nt2.ini). Defaults follow the
NT-stage config used by runMegaPath.sh (-u 750 -v 1 -top 95 -F,
soap4-nt2.ini [MMP]/[DP]).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class MmpParams:
    """[MMP] seeding parameters (soap4-nt2.ini)."""

    sa_size_threshold: int = 30  # mmpSeedSAsizeThreshold
    seed_min_length: int = 17  # mmpSeedMinLength (NT; 22 for hg)
    uniq_threshold: int = 6  # mmpUniqThreshold
    indel_fuzz: int = 5  # mmpIndelFuzz
    good_seed_len: int = 27  # mmpGoodSeedLen
    reseed_len: int = 18  # mmpReseedLen (NT; 23 for hg)
    reseed_rlt_ratio: float = 0.7  # mmpReseedRLTratio
    reseed_abs_diff: int = 4  # mmpReseedAbsDiff
    short_seed_ratio: float = 0.5  # mmpShortSeedRatio
    # Walk truncation (no reference counterpart): the lockstep
    # walk's wall clock is the SLOWEST walker, and
    # wrong-strand/junk walkers grind ~5 steps per consumed char
    # (short extension + fail + overlap rollback) while productive
    # walkers run ~1 step/char. Retire a walker once its step count
    # exceeds kill_ratio * chars_consumed + kill_base — a per-walker
    # deterministic rule (independent of batch composition, so shard/
    # placement parity is preserved). The reference has no such rule;
    # it runs each read to completion on a pthread pool where only
    # TOTAL work matters (DV-DPfunctions.cpp:2394-2402). Validated by
    # the soap4/cascade parity suites; set kill_ratio=0 to disable.
    #
    # Sensitivity dial, MEASURED on the 512 Mbp bench shard (40k read
    # ends vs the reference binary): 2.5/80 (default) gives 76/40000
    # read-end misses (99.81% parity; the misses are mutated reads in
    # rollback-heavy contexts whose walkers breach the budget);
    # 3.0/96 gives 10/40000; kill_ratio=0 is EXACT and slowest. The
    # exact rescue (AlignEngine.exact_rescue) recovers every miss.
    # Small-genome fixtures (all parity suites) are exact at the
    # default. Its speed on the card is not measured yet.
    kill_ratio: float = 2.5
    kill_base: int = 80
    # Sibling-evidence cull: ~50% of walkers are
    # wrong-strand "junk" that grind ~8 charged steps per net char to
    # the progress-kill bound and set the lockstep walk's width x
    # steps wall clock. A naive time-based junk kill cannot separate
    # them from LEGIT walkers blocked by a read error near the walk
    # start (both fail every MMP at the random-match length until the
    # error clears — measured: a 64-step no-evidence kill cost
    # 322/40000 production misses vs 76 at the r4 default). The
    # mode-invariant discriminator is the OPPOSITE-STRAND SIBLING: a
    # matching read's true-strand walker shows a >= good_seed_len
    # extension by ~charged step 30, while an error-read's sibling is
    # itself junk. One-shot probe: when a walker's charged-step count
    # crosses sibling_kill_steps (or it retires, whichever first) it
    # latches (probe = seed_len >= good_seed_len; victim = no stored
    # seed, no rollback state, sub-minimum extension). A latched
    # victim FREEZES (uncharged) until its sibling has latched, then
    # dies if the sibling probed true, else resumes from its frozen
    # state. Because latch and freeze are defined purely on the
    # per-walker charged clock, the kill set and every survivor's
    # seed output are identical across walk modes and host/device —
    # the audit measures the only divergence (vs the reference, which
    # walks wrong-strand walkers to completion): a killed walker's
    # would-be random >= min_len seeds, which cannot pass the DP
    # threshold (score 30 needs ~30 aligned chars; a wrong-locus
    # 17-mer extends at -1.25/char). MEASURED on the 512 Mbp audit
    # (tools/parity_audit.py, r5): T0=48 -> the same 76/40000 misses
    # as with the cull disabled, identical reports. 0 disables.
    sibling_kill_steps: int = 48


@dataclass(frozen=True)
class AlignParams:
    """Engine-level parameters (soap4 CLI + [DP]/[PairEnd] sections)."""

    # scoring ([DP])
    match: int = 1
    mismatch: int = -2
    gap_open: int = -3
    gap_extend: int = -1
    # hit thresholds (definitions.h:166-167 DP2_SCORE_THRESHOLD_*)
    cutoff_ratio: float = 0.2
    cutoff_lower_bound: int = 30
    # insert window (-u/-v flags; runMegaPath.sh uses -u 750)
    insert_high: int = 750
    insert_low: int = 1
    # hit retention (-top N => keep hits >= N% of best)
    top_percentage: float = 0.95
    # megapath mode: 1 = -F (report unpaired), 2 = -P (pair required)
    megapath_mode: int = 1
    # per-read output caps ([PairEnd] MaxOutputPerPair)
    max_output_per_pair: int = 200
    max_hits_per_end: int = 8000  # MaxHitsEachEndForPairing
    # candidate-compression gap (DP2_DIVIDE_GAP, DV-DPfunctions.cpp:...)
    divide_gap: int = 5
    mmp: MmpParams = field(default_factory=MmpParams)
    # deep-DP rounds (alignment.cpp:91-137): unaligned pairs re-seed
    # with the next round's parameters. Every ini shipped with the
    # MegaPath driver (soap4.ini for hg/ribo, soap4-nt2.ini for NT)
    # sets NumberOfRoundOfDeepDPForLongReads=1, so the default is one
    # round with ``mmp``; multi-round configs list per-round MmpParams.
    extra_rounds: tuple = ()
    # single-end DP candidate cap per read end
    # (DV-DPForSingleReads.cpp:200 "WARNING HARDCODE": first 200
    # clustered candidates per readID proceed to DP)
    max_se_candidates: int = 200

    @property
    def seeding_rounds(self) -> tuple:
        return (self.mmp,) + tuple(self.extra_rounds)

    def margin(self, read_len: int) -> int:
        """DP window margin (DP2_MARGIN, DV-DPfunctions.cpp:1760)."""
        return 30 if read_len > 100 else 25

    def dp_threshold(self, read_len: int) -> int:
        """Per-end keep threshold (DV-DPfunctions.cpp:3439-3440)."""
        return max(int(self.cutoff_ratio * read_len), self.cutoff_lower_bound)

    def with_(self, **kw) -> "AlignParams":
        return replace(self, **kw)


HUMAN_FILTER = AlignParams(
    insert_high=750,
    top_percentage=0.1,  # -top default irrelevant; filter keys off score only
    mmp=MmpParams(seed_min_length=22, reseed_len=23),
)

NT_STAGE = AlignParams()
