"""Codec configuration.

One frozen dataclass of algorithm knobs flowing into kernels as static args —
the replacement for the reference's three config layers
(CompressionParameters, CompressionAccelerator.scala:12-23; CopyCompressParams,
CopyCompress.scala:9-11; Rocket Config mixins, Configs.scala:87-99), resolving
its acknowledged "change all the magic numbers to parameters" debt
(CompressionAccelerator.scala:52).
"""

from __future__ import annotations

import dataclasses

from . import format as fmt


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    #: LZ fragment size; matches never cross fragments. 64 KB is the format's
    #: effective window (16-bit copy2 offsets), so no sliding window is
    #: needed — the reference needed one only because its scratchpad was
    #: 50 KB (MemoryController.scala:184-187).
    block_size: int = fmt.BLOCK_SIZE

    # (No hash_bits knob: the reference sizes a 512-entry SRAM hash table
    # (HashTable.scala:27) and software Snappy sizes per input
    # (format.hash_table_bits, used by the host/golden codecs); the device
    # matcher is sort-based — one collision-free bucket per position by
    # construction — so there is nothing for such a knob to configure.)

    #: Number of candidate slots carried per position through the restore
    #: sort and the sticky scan (restore payload = candidates/2 u32 words;
    #: sticky membership cost ~ candidates^2). 14 is the swept sweet spot:
    #: it clears the software-Snappy ratio bar on every corpus class incl.
    #: low-entropy hex dumps (alignerTestData -2 B vs golden; full corpus
    #: +mtg aggregate 3.1% under golden vs 3.7% at 16) at one less restore
    #: payload word and 23% less membership work. K=12 additionally loses
    #: only alignerTestData (+16 B) — see the dedup note below.
    candidates: int = 14

    #: Number of rank-space sort neighbors probed per position. When
    #: probes > candidates, the probed ascending offsets are dedup-compacted
    #: into the slots: the contiguous offset ladder rooted at 1 that byte
    #: runs generate (1,2,3,…) is RLE-redundant with offset 1 and dropped.
    #: This recovers most of K=16's parse quality at K=12 but NOT all:
    #: uniform regions (e.g. zero runs with a 17-byte line period) place the
    #: structurally-critical offset at rank ~13 inside a consecutive ladder
    #: NOT rooted at 1, where no sound local rule can identify it — point
    #: slots simply need the width (an interval-set candidate table would
    #: cover it, but costs more in sticky composition than it saves in the
    #: restore sort). Default equal to `candidates` = no dedup, bit-exact
    #: legacy table.
    probes: int = 14

    #: Segment size for the bounded-state commit scan. Must equal
    #: MAX_COPY_LEN: the scan state (distance to next committed position)
    #: lives in [0, seg) because no element advances more than 64 bytes.
    commit_segment: int = fmt.MAX_COPY_LEN

    #: Per-block compressed-output capacity (worst case + slack), bytes.
    #: Snappy worst case for 64 KB is 65539 + preamble; round up to a
    #: multiple of 1024.
    block_capacity: int = fmt.BLOCK_SIZE + 2048

    #: Chain-flattening mode: prefer the oldest 8-byte-verified occurrence
    #: over the nearest when choosing match offsets, collapsing decode copy
    #: chains (fewer pointer-doubling rounds). "class" preserves the nearest
    #: candidate's tag class (measurably improves ratio on text: full corpus
    #: 0.960 vs snappy with, 0.965 without, at ~15% encode cost); "full"
    #: always takes the globally-first occurrence, upgrading some copy1 tags
    #: to copy2 (+1 B each) to buy decoder doubling rounds; "lift" replaces
    #: the oldest-occurrence role with a base-16 digit-lift ancestor
    #: (bars-PASS, mtg ratio -51150 vs golden vs "class"'s -48683, but
    #: decode-depth NEUTRAL — the gate+sticky+commit pipeline washes out
    #: the digit alignment — and it costs 3 extra rank-space forward-fills,
    #: so "class" stays default); "off" disables flattening. See
    #: encode._flat_gate.
    flatten: str = "class"

    #: Lazy (one-position-lookahead) parsing threshold. 0 = pure greedy.
    #: g >= 1 defers a match at i (emitting a literal byte instead) whenever
    #: the match starting at i+1 is at least g bytes longer — the classic
    #: zstd/gzip lazy heuristic, reformulated as a stateless per-position
    #: mask over the propagated match lengths (a deferral chain is handled
    #: by the commit scan, not by sequential re-evaluation). Swept 0-3 for
    #: ratio: g=2 strictly improves ratio on text (mtg corpus -3454 B,
    #: real-50000 -58 B, corpus bars unchanged) at the cost of 4 fused
    #: elementwise ops; g=1 ties break badly (defers into equal-length
    #: chains), g=3 gives back half of g=2's win. K=13/12 + probe dedup remain ratio-infeasible
    #: even with the lazy cushion (alignerTestData +5/+15 B vs golden).
    lazy: int = 2

    #: Sticky-composition membership strategy. "exact" = K^2 compares per
    #: level (the reference semantics); "sig" = 32-bucket hash-signature
    #: membership (O(K) per level) with a final exact re-verification gate,
    #: so every emitted offset stays sort-verified either way — a signature
    #: collision can only change a tie-break to another valid candidate.
    #: "sig" costs 1.4% ratio on text (1302409 vs 1284628 B on the mtg
    #: corpus); every BASELINE bar still clears. The speed presets use it;
    #: "exact" stays the default.
    sticky: str = "exact"

    #: Match-anchor stride: candidates are searched only at every
    #: stride-th position, shrinking the pair-sort / probe / restore-sort
    #: domain by the stride (those stages are ~60% of encode at small K).
    #: Positions without candidates parse as literals and match EXTENSION
    #: stays byte-granular, so strided anchors still cover intermediate
    #: content; all emitted offsets become stride multiples (offset-1 RLE
    #: degrades to offset-stride — same asymptotic ratio on runs).
    #: Measured ratio cost at stride 2, K=3: mtg x1.23, real-50000 x1.26
    #: vs software snappy — inside the reference RTL's own x1.57 point.
    stride: int = 1

    #: Candidate-table representation. "points" = K point slots (the
    #: production table). "intervals" = the round-5 probe of the
    #: interval-set idea from the `probes` note above: the longest
    #: consecutive probe ladder NOT rooted at 1 is carried as ONE
    #: (lo, hi) interval in the last two slots (every integer in a probe
    #: ladder is a sort-verified occurrence offset, so interval
    #: membership stays exact), freeing point slots so a lower K can
    #: cover the uniform-region ladders that pinned K=14. Sticky
    #: membership tests the interval with two compares; composition
    #: intersects intervals (an under-approximation — cross terms
    #: between one window's points and the other's interval are dropped
    #: — which can only break a chain early, never emit an unverified
    #: offset). Requires even candidates >= 6, probes > candidates, and
    #: a flattening slot; runs on the XLA matcher path.
    table: str = "points"

    #: Mesh axis name for data-parallel block sharding.
    dp_axis: str = "dp"

    def __post_init__(self) -> None:
        if self.block_size > fmt.BLOCK_SIZE:
            raise ValueError("block_size may not exceed the 64 KB Snappy window")
        if self.commit_segment != fmt.MAX_COPY_LEN:
            raise ValueError("commit_segment must equal MAX_COPY_LEN (scan invariant)")
        if self.stride not in (1, 2, 4):
            raise ValueError("stride must be 1, 2 or 4 (power of two dividing"
                             " the block)")
        if self.table not in ("points", "intervals"):
            raise ValueError("table must be 'points' or 'intervals'")
        if self.table == "intervals":
            if self.candidates % 2 or self.candidates < 6:
                raise ValueError("interval tables need even candidates >= 6")
            if self.probes <= self.candidates:
                raise ValueError("interval tables need probes > candidates")
            if self.flatten == "off":
                raise ValueError("interval tables need a flattening slot")
            if self.stride != 1:
                # Strided anchors make every offset a stride multiple, so
                # the +1-consecutive run detector can never fire — the
                # interval slots would ride along permanently empty.
                raise ValueError("interval tables require stride == 1")


DEFAULT_CONFIG = CodecConfig()

#: Speed-over-ratio encode preset (the encode mirror of the framed
#: sidecar's size-for-decode-speed trade; like zstd's negative levels,
#: an explicit opt-in). K=8 shrinks the restore-sort payload from 8 to 5
#: operands and the sticky membership work ~3x. Aggregate text ratio
#: stays under software Snappy (x0.9941 on the mtg corpus), but the
#: per-file bars the default holds strictly are traded away:
#: alignerTestData +31 B (+17%), real-50000 +153 B (+0.7%), real-10000
#: +180 B (+4.9%), random +1 B. Round-trips stay bit-exact (correctness is
#: never traded). Its speed on the card: not measured.
FAST_CONFIG = CodecConfig(candidates=8, probes=8)

#: Matched-ratio "turbo" preset: the speed edge at the REFERENCE RTL's own
#: ratio trade. The RTL's headline 3.50 cyc/B on real-50KB comes at a
#: compressed size 1.57x LARGER than software Snappy (32683 vs 20795 B;
#: reference benchmark/hw_results.csv:25 and sw_results.csv:22) — a ratio
#: trade the DEFAULT/FAST presets refuse. K=3 + signature sticky
#: membership keeps aggregate size at x1.073 vs software Snappy (ratio
#: sweeps: K=2 gains nothing over K=3; flatten="off" also feeds the odd-K
#: packed restore worse). Round-trips stay bit-exact; only ratio is
#: traded. Its speed on the card: not measured.
TURBO_CONFIG = CodecConfig(candidates=3, probes=3, sticky="sig")

#: TURBO plus stride-2 match anchors (the pair-sort/probe/restore domain
#: halves and the window build drops to a u16 reinterpretation; see
#: `stride`): aggregate size x1.357 vs software snappy vs the RTL's
#: x1.571, and on the RTL's own benchmark file (real-50000) the output is
#: 8.6% SMALLER than the RTL's recorded 32683 B. The stride-2 ratio cost
#: is structural (even-only anchors AND sources), so raising K recovers
#: little (K=14 s=2: x1.263); stride 4 breaks the RTL's ratio (x1.77).
#: Round-trips stay bit-exact. Its speed on the card: not measured.
ULTRA_CONFIG = CodecConfig(candidates=3, probes=3, sticky="sig", stride=2)
