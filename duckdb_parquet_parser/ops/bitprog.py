"""Bit-parallel NFA programs — general regex at bitap speed in elementwise int32 ops.

Substring chains walk as Shift-And (bitap) registers; every other pattern
would fall to the one-hot matmul DFA, whose per-byte transition is far
heavier.  This module closes that gap by
generalizing bitap to the full *extended Shift-And* family (Glushkov NFA
simulation, cf. Navarro & Raffinot's "Flexible Pattern Matching"), keeping
the per-byte cost at a handful of [N] int32 vector ops with ZERO gathers:

  * positions carry byte CLASSES (sets), not just literal bytes — class
    membership folds into the per-byte mask via interval compares, with
    compare results shared across all positions/segments using a class;
  * quantifiers ? / * / + / {m,n} become optional (O) / repeatable (R)
    position masks: repeats are a self-loop term `reg & R & B`, optionals a
    DOUBLING epsilon smear `F |= (F & T_k) << 2^k` (T_k = all-optional
    2^k-spans, _smear_plan) — log2(longest optional run) steps on the
    pre-byte entering set;
  * '.*' gaps split the pattern into SEGMENTS chained through sticky done
    bits exactly like the bitap needle chain (a segment seeds only after its
    predecessor has completed);
  * top-level alternation compiles each branch to its own machine (bounded
    fan-out), OR-ing accepts; single-byte alternations collapse to classes;
  * edge anchors (whole-pattern '^'/'$', DFA-compiler semantics — LIKE
    'lit%' / '%lit') become first-byte-only seeding (driven by a shared
    marker register that the value-boundary reset zeroes) and non-sticky
    accepts sampled at the value's last byte.

  * WIDE segments (> 31 positions — long literals, big counted repeats)
    span up to MAX_WIDE_REGS carry-chained registers: the old top position
    shifts into the next register's bit 0, and optional tops additionally
    forward their post-smear entering bit, so quantifier runs and accept
    runs cross register boundaries transparently.

Anything outside this family (inner anchors, nested unbounded groups,
counted repeats beyond MAX_COUNTED, segments beyond 124 positions, >16-way
fan-out) raises BitprogUnsupported and callers fall back to the table DFA —
survivor sets are identical either way (tested against the DFA/numpy
oracle).

A pure substring chain lowers to singleton-class ONE positions: the emitted
transition is then exactly the round-1 bitap (same masks, same register
count), so this module subsumes ops/strings.make_bitap_transition.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .regex import ANY, UnsupportedPattern, escape_set, parse_class_at

MAX_MACHINES = 16      # top-level alternation fan-out bound
MAX_SEGMENTS = 8       # '.*' gaps per machine (done bits share an int32)
MAX_POSITIONS = 31     # positions per register (int32 bits 0..30)
MAX_WIDE_REGS = 4      # registers a single WIDE segment may span (carry-chained)
MAX_COUNTED = 1 << 16  # {m,n} token-expansion sanity cap per atom.  The REAL
                       # register bound (MAX_POSITIONS * MAX_WIDE_REGS = 124
                       # positions per segment) is enforced AFTER the run
                       # collapses in compile_bitprog — a LEADING same-class
                       # {m,n} of any size becomes a streak counter
                       # (_collapse_lead_runs), and an INTERIOR one becomes
                       # an ANCHORED counter (_collapse_interior_runs), so
                       # 'x{500}', '[a-z]{2000}q', 'a[0-9]{200}b' and
                       # 'q[ab]{500,}z' all compile.  Still raising: bounded
                       # interior runs whose prefix shares the run class
                       # ('a[ab]{200}c' — the counter can't tell anchor age)
                       # past 124 positions


class BitprogUnsupported(UnsupportedPattern):
    pass


# ── AST ─────────────────────────────────────────────────────────────────────


@dataclass
class Lit:
    cls: frozenset


@dataclass
class Cat:
    items: list


@dataclass
class Alt:
    options: list


@dataclass
class Rep:
    item: object
    lo: int
    hi: int | None  # None = unbounded


@dataclass
class Anch:
    kind: str  # '^' or '$'


def _parse(pattern: str):
    """Pattern -> AST (raises BitprogUnsupported on anchors/lookaround)."""
    p, n = pattern, len(pattern)
    i = 0

    def peek():
        return p[i] if i < n else None

    def alt():
        nonlocal i
        opts = [cat()]
        while peek() == "|":
            i += 1
            opts.append(cat())
        return opts[0] if len(opts) == 1 else Alt(opts)

    def cat():
        nonlocal i
        items = []
        while (c := peek()) is not None and c not in "|)":
            items.append(rep())
        return Cat(items)

    def rep():
        nonlocal i
        node = atom()
        if isinstance(node, Anch) and peek() in ("*", "+", "?", "{"):
            raise BitprogUnsupported("quantified anchor")
        while (c := peek()) in ("*", "+", "?", "{"):
            if c == "{":
                import re as _re

                m = _re.match(r"\{(\d+)(,(\d*))?\}", p[i:])
                if not m:
                    raise BitprogUnsupported("bad counted repeat")
                i += m.end()
                lo = int(m.group(1))
                hi = (lo if m.group(2) is None
                      else (None if m.group(3) == "" else int(m.group(3))))
                if hi is not None and hi < lo:
                    raise BitprogUnsupported("bad counted repeat bounds")
                node = Rep(node, lo, hi)
                continue
            i += 1
            node = Rep(node, 0 if c in "*?" else 1, None if c in "*+" else 1)
        return node

    def atom():
        nonlocal i
        c = peek()
        if c is None:
            raise BitprogUnsupported("empty atom")
        i += 1
        if c == "(":
            if peek() == "?":
                i += 1
                if peek() != ":":
                    raise BitprogUnsupported("lookaround / named groups")
                i += 1
            node = alt()
            if peek() != ")":
                raise BitprogUnsupported("unbalanced group")
            i += 1
            return node
        if c == "[":
            cls, ni = parse_class_at(p, i)
            i = ni
            return Lit(cls)
        if c == ".":
            return Lit(ANY)
        if c == "\\":
            e = peek()
            if e is None:
                raise BitprogUnsupported("trailing backslash")
            i += 1
            return Lit(escape_set(e))
        if c in "*+?{":
            raise BitprogUnsupported(f"dangling quantifier '{c}'")
        if c in "^$":
            return Anch(c)  # inner anchors resolve in _segment
        return Lit(frozenset([ord(c)]))

    tree = alt()
    if i != n:
        raise BitprogUnsupported(f"trailing junk at {i}")
    return tree


# ── lowering: AST -> machines of segments of positions ──────────────────────

Q_ONE, Q_OPT, Q_PLUS, Q_STAR = 0, 1, 2, 3
GAP = "gap"      # segment separator marker ('.*')
ANCH_S = "anch_s"  # inner '^' token (resolved per branch in _segment)
ANCH_E = "anch_e"  # inner '$' token


@dataclass
class Segment:
    cls: list = field(default_factory=list)    # frozenset per position
    quant: list = field(default_factory=list)  # Q_* per position


@dataclass
class Machine:
    segments: list = field(default_factory=list)
    lead_gap: bool = False   # '.*' (or an absorbed optional run) before content
    trail_gap: bool = False  # '.*' after the last content
    anch_s: bool = False     # first segment seeds only at the value's 1st byte
    anch_e: bool = False     # accept sampled non-sticky (match must END at the
                             # value's last byte)
    always: bool = False     # matches every value incl. empty ('.*', 'a?', …)
    lead_run: tuple | None = None  # (cls, mand, sticky): leading same-class
                             # position run collapsed to a saturating counter
                             # (_collapse_lead_runs); segments hold the residual
    mid_run: tuple | None = None   # (cls, mand, cap, bounded): INTERIOR
                             # same-class run collapsed to an anchored counter
                             # (_collapse_interior_runs); segments then hold
                             # [prefix] or [prefix, suffix]


def _as_class(node) -> frozenset | None:
    """Single-byte-consuming view of a node, or None."""
    if isinstance(node, Lit):
        return node.cls
    if isinstance(node, Alt):
        parts = [_as_class(o) for o in node.options]
        if all(x is not None for x in parts):
            out: frozenset = frozenset()
            for x in parts:
                out |= x
            return out
    if isinstance(node, Cat) and len(node.items) == 1:
        return _as_class(node.items[0])
    return None


def _flatten(node) -> list[list]:
    """Node -> alternatives, each a flat token list (frozenset positions with
    quantifiers as (cls, Q_*) tuples, or GAP markers)."""

    def cross(seqs_a: list[list], seqs_b: list[list]) -> list[list]:
        out = [a + b for a in seqs_a for b in seqs_b]
        if len(out) > MAX_MACHINES:
            raise BitprogUnsupported("alternation fan-out too large")
        return out

    if isinstance(node, Lit):
        return [[(node.cls, Q_ONE)]]

    if isinstance(node, Anch):
        return [[ANCH_S if node.kind == "^" else ANCH_E]]

    if isinstance(node, Cat):
        seqs: list[list] = [[]]
        for item in node.items:
            seqs = cross(seqs, _flatten(item))
        return seqs

    if isinstance(node, Alt):
        out = []
        for o in node.options:
            out.extend(_flatten(o))
        if len(out) > MAX_MACHINES:
            raise BitprogUnsupported("alternation fan-out too large")
        return out

    if isinstance(node, Rep):
        cls = _as_class(node.item)
        if cls is not None:
            if node.lo == 0 and node.hi is None and cls == ANY:
                return [[GAP]]  # '.*' — the unanchored gap
            if max(node.lo, node.hi or 0) > MAX_COUNTED:
                raise BitprogUnsupported("counted repeat too large")
            if node.hi is None:
                if node.lo == 0:
                    return [[(cls, Q_STAR)]]
                return [[(cls, Q_ONE)] * (node.lo - 1) + [(cls, Q_PLUS)]]
            return [[(cls, Q_ONE)] * node.lo + [(cls, Q_OPT)] * (node.hi - node.lo)]
        # bounded repeat of a multi-byte group: expand by concatenation
        if node.hi is not None and node.hi <= 4:
            inner = _flatten(node.item)
            out = []
            for count in range(node.lo, node.hi + 1):
                seqs: list[list] = [[]]
                for _ in range(count):
                    seqs = cross(seqs, inner)
                out.extend(seqs)
            if len(out) > MAX_MACHINES:
                raise BitprogUnsupported("alternation fan-out too large")
            return out
        raise BitprogUnsupported("unbounded repeat of a multi-byte group")

    raise BitprogUnsupported(f"node {type(node).__name__}")


def _segment(tokens: list) -> Machine | None:
    """Token list -> Machine.  Returns None for a branch that can never
    match (an inner anchor with required content on its outer side — e.g.
    'a^b' / 'a$b' never match, exactly like Python re without MULTILINE).
    Inner anchors that are edge-EQUIVALENT (only assertion-transparent
    positions outside them, e.g. '(^a)b') set the machine's anchor flags;
    anchors adjacent to optionals or gaps raise (genuinely positional)."""
    m = Machine()
    seg = Segment()
    raw: list[Segment] = []
    saw_content = False
    saw_required = False
    anch_e_seen = False
    for tok in tokens:
        if tok is ANCH_S:
            if anch_e_seen:
                return None  # '$^…' with content around: unmatchable
            if not saw_content and not m.lead_gap:
                m.anch_s = True
                continue
            if saw_required:
                return None  # required bytes before '^': never matches
            raise BitprogUnsupported("anchor adjacent to optionals/gaps")
        if tok is ANCH_E:
            anch_e_seen = True
            continue
        if anch_e_seen:
            if tok is GAP:
                raise BitprogUnsupported("anchor adjacent to optionals/gaps")
            _cls, _q = tok
            if _q in (Q_ONE, Q_PLUS):
                return None  # required bytes after '$': never matches
            raise BitprogUnsupported("anchor adjacent to optionals/gaps")
        if tok is GAP:
            if seg.cls:
                raw.append(seg)
                seg = Segment()
            if not saw_content:
                m.lead_gap = True
            m.trail_gap = True
            continue  # empty segment between gaps collapses
        cls, q = tok
        if not cls:
            raise BitprogUnsupported("empty byte class")
        seg.cls.append(cls)
        seg.quant.append(q)
        saw_content = True
        saw_required = saw_required or q in (Q_ONE, Q_PLUS)
        m.trail_gap = False
    if anch_e_seen:
        if m.trail_gap or (seg.cls and not any(
                q in (Q_ONE, Q_PLUS) for q in seg.quant)):
            raise BitprogUnsupported("anchor adjacent to optionals/gaps")
        m.anch_e = True
    if seg.cls:
        raw.append(seg)
    # drop fully-optional segments: they are absorbed by the gap around them
    # (a dropped EDGE segment also absorbs any edge anchor — the optional run
    # plus its gap can match anything, so the machine is gap-edged there)
    m.segments = [
        s for s in raw
        if any(q in (Q_ONE, Q_PLUS) for q in s.quant)
    ]
    if not m.segments:
        # no required position anywhere: the branch matches EVERY value
        # (search semantics — an empty match exists at some offset), unless
        # anchors pin BOTH edges without a gap to absorb them (then the
        # match set is value-dependent: fall back)
        if m.anch_s and m.anch_e and not (m.lead_gap or m.trail_gap):
            raise BitprogUnsupported(
                "empty-matching branch pinned by both anchors")
        m.always = True
        return m
    if raw[0] is not m.segments[0]:
        m.lead_gap = True
    if raw[-1] is not m.segments[-1]:
        m.trail_gap = True
    if len(m.segments) > MAX_SEGMENTS:
        raise BitprogUnsupported("too many '.*' gaps")
    # NOTE: segment-length limits are enforced in compile_bitprog AFTER
    # _collapse_lead_runs (a leading same-class run of any length collapses
    # to a counter register and escapes the position budget entirely)
    return m


LEAD_RUN_MIN = 9  # below this, the positions ride an existing shift ladder
                  # for free; at/above, a counter register wins


def _collapse_lead_runs(machines: list[Machine]) -> None:
    """Collapse each unanchored machine's leading run of SAME-CLASS positions
    into a saturating-counter register (Machine.lead_run).

    Valid because an unanchored machine seeds a fresh match attempt at EVERY
    byte: the run lengths that can precede the residual at byte t form the
    full range {mand .. current same-class streak}, so "the residual may
    start at byte t" reduces to "the streak of class bytes ending at t-1 is
    >= mand" (mand = the run's required-position count).  The run's upper
    bound and its optional/repeatable structure are both irrelevant — a
    streak of k >= mand class bytes always contains a suffix the run
    accepts.  The transition then pays ~4 ops/byte for the whole run
    (saturating count + compare) instead of a 31-bit shift ladder per
    register chunk — `[a-z ]{30,45}requests` drops from 2 carry-chained
    registers (53 positions) to a counter plus an 8-position register.

    sticky: the run was segment 0 ENTIRELY, so run-done feeds segments[1:]
    like a '.*' done bit (once seen, seeds forever).  Non-sticky: the run
    was a strict prefix of segment 0 — the residual's first position must
    match the byte immediately after the streak, so it is seeded per byte
    from the live counter."""
    for m in machines:
        if m.anch_s or m.always or not m.segments:
            continue
        seg = m.segments[0]
        cls0 = seg.cls[0]
        j = 1
        while j < len(seg.cls) and seg.cls[j] == cls0:
            j += 1
        if j < LEAD_RUN_MIN:
            continue
        mand = sum(1 for q in seg.quant[:j] if q in (Q_ONE, Q_PLUS))
        if mand < 1:
            continue  # all-optional run: machine-level semantics unchanged
        rest_cls, rest_q = seg.cls[j:], seg.quant[j:]
        sticky = not rest_cls
        if not sticky and not any(q in (Q_ONE, Q_PLUS) for q in rest_q):
            # residual prefix with no required position: acceptance would
            # need counter-OR-register accepts — rare shape, keep registers
            continue
        residual = ([] if sticky else [Segment(cls=rest_cls, quant=rest_q)])
        residual += m.segments[1:]
        if sum(len(s.cls) for s in residual) > MAX_POSITIONS:
            continue  # v1: residual must fit one fused register
        m.lead_run = (cls0, mand, sticky)
        m.segments = residual


def _collapse_interior_runs(machines: list[Machine]) -> None:
    """Collapse a long INTERIOR same-class position run into an ANCHORED
    saturating counter (Machine.mid_run) — `a[0-9]{200}b` compiles without
    the table-DFA fallback.

    Model: the machine's single segment splits into PREFIX | RUN | SUFFIX.
    The prefix is an ordinary (sub-31-position) register whose accept bit
    p_t = "prefix ends at byte t" anchors the counter; the counter tracks
    the run-class streak since its anchor; the suffix register is seeded
    from the counter window, exactly like the lead-run residual.

    Soundness:
      * unbounded runs ({m,}): the counter keeps the EARLIEST anchor alive
        through the streak (later p-events inside the streak are redundant
        — a longer streak-suffix always contains an acceptable one), so
        seed = (streak since earliest anchor) >= mand is exact.
      * bounded runs ({m,u}): exactness needs the anchor age, which a
        single counter only knows when anchors can occur ONLY at streak
        starts — guaranteed when every class that can END the prefix (its
        last required position + trailing optionals = the acc_mask
        positions) is DISJOINT from the run class: a p-event byte is then
        never a run-class byte, so each streak has at most one anchor and
        the streak length IS the age.  Non-disjoint bounded runs keep
        their registers (and fall back to the DFA past 124 positions).

    Within one same-class run the ORDER of required/optional positions is
    irrelevant (the acceptable consume-counts are [mand, n_positions] — or
    [mand, inf) with a STAR/PLUS) so mixed shapes like `[0-9]{3}[0-9]*`
    collapse too."""
    for m in machines:
        if m.lead_run is not None or m.always or m.anch_s:
            continue
        if len(m.segments) != 1:
            continue
        seg = m.segments[0]
        n = len(seg.cls)
        best = None  # (length, i, j) of the longest same-class run
        i = 0
        while i < n:
            j = i + 1
            while j < n and seg.cls[j] == seg.cls[i]:
                j += 1
            if best is None or j - i > best[0]:
                best = (j - i, i, j)
            i = j
        if best is None or best[0] <= MAX_POSITIONS:
            continue  # short runs: plain registers are cheaper
        _, i, j = best
        if i == 0:
            continue  # leading run: _collapse_lead_runs territory
        run_cls = seg.cls[i]
        runq = seg.quant[i:j]
        mand = sum(1 for q in runq if q in (Q_ONE, Q_PLUS))
        if mand < 1:
            continue  # all-optional run: acceptance may skip it entirely
        unbounded = any(q in (Q_STAR, Q_PLUS) for q in runq)
        cap = 0 if unbounded else (j - i)
        pre_cls, pre_q = seg.cls[:i], seg.quant[:i]
        suf_cls, suf_q = seg.cls[j:], seg.quant[j:]
        if len(pre_cls) > MAX_POSITIONS or len(suf_cls) > MAX_POSITIONS:
            continue  # v1: prefix/suffix must each fit one register
        if not any(q in (Q_ONE, Q_PLUS) for q in pre_q):
            continue  # prefix must consume >= 1 byte (p is a register bit)
        if suf_cls and not any(q in (Q_ONE, Q_PLUS) for q in suf_q):
            continue  # would need counter-OR-register accepts — rare shape
        if not unbounded:
            k = len(pre_cls) - 1
            ok = True
            while k >= 0:
                if pre_cls[k] & run_cls:
                    ok = False
                    break
                if pre_q[k] in (Q_ONE, Q_PLUS):
                    break
                k -= 1
            if not ok:
                continue  # bounded + shared classes: age would be ambiguous
        m.mid_run = (run_cls, mand, cap, not unbounded)
        m.segments = [Segment(cls=pre_cls, quant=pre_q)]
        if suf_cls:
            m.segments.append(Segment(cls=suf_cls, quant=suf_q))


@dataclass
class BitProgram:
    machines: list            # list[Machine]
    pattern: str
    fingerprint: tuple = ()   # hashable identity for jit caches
    always: bool = False      # matches every value incl. empty; machines
                              # empty + not always = matches NOTHING (all
                              # branches carried unsatisfiable inner anchors)

    @property
    def n_registers(self) -> int:
        """Unpacked upper bound (one register per 31-position segment chunk
        + a done word per machine + the first-byte marker);
        make_bitprog_transition packs gap-free machines into shared
        registers and reports the true count."""
        return sum(
            sum(-(-len(s.cls) // MAX_POSITIONS) for s in m.segments) + 1
            + (2 if m.lead_run else 0)
            + (1 if m.mid_run else 0)  # the anchored counter word
            for m in self.machines
        ) + 1


def compile_bitprog(pattern: str) -> BitProgram:
    """Pattern -> BitProgram (raises BitprogUnsupported outside the extended
    Shift-And family).  Search semantics exactly like the DFA compiler:
    unanchored unless ^/$ sit at the pattern edges, and an edge anchor
    applies to the WHOLE pattern — '^a|b' means '^(a|b)', matching
    compile_pattern (regex.py:457-462), not Python re."""
    pat = pattern
    # NOTE: no '^.*' / '.*$' wrapper stripping here — under a top-level
    # alternation the edge anchor applies to EVERY branch ('a|b.*$' means
    # '(a|b.*)$'), so the wrapper only defeats the anchor for the branch
    # that carries the gap; _segment records that per machine (lead_gap /
    # trail_gap) and the anchor flags below honor it.
    anchor_start = pat.startswith("^")
    if anchor_start:
        pat = pat[1:]
    anchor_end = pat.endswith("$") and not pat.endswith("\\$")
    if anchor_end:
        pat = pat[:-1]
    machines = [m for m in (_segment(toks) for toks in _flatten(_parse(pat)))
                if m is not None]  # None = a never-matching branch (dropped)
    always = False
    kept = []
    for m in machines:
        m.anch_s = m.anch_s or (anchor_start and not m.lead_gap)
        m.anch_e = m.anch_e or (anchor_end and not m.trail_gap)
        if m.always:
            if m.anch_s and m.anch_e:
                raise BitprogUnsupported(
                    "empty-matching branch pinned by both anchors")
            always = True  # one always-branch accepts every value
            continue
        kept.append(m)
    machines = [] if always else kept
    _collapse_lead_runs(machines)
    _collapse_interior_runs(machines)
    for m in machines:
        for s in m.segments:
            if len(s.cls) > MAX_POSITIONS * MAX_WIDE_REGS:
                raise BitprogUnsupported("segment too long")
    fp = (always, tuple(
        (
            m.anch_s,
            m.anch_e,
            (None if m.lead_run is None
             else (tuple(sorted(m.lead_run[0])), m.lead_run[1], m.lead_run[2])),
            (None if m.mid_run is None
             else (tuple(sorted(m.mid_run[0])), m.mid_run[1], m.mid_run[2],
                   m.mid_run[3])),
            tuple(
                tuple(
                    (tuple(sorted(c)), q)
                    for c, q in zip(s.cls, s.quant)
                )
                for s in m.segments
            ),
        )
        for m in machines
    ))
    return BitProgram(machines=machines, pattern=pattern, fingerprint=fp,
                      always=always)


# ── transition builder ──────────────────────────────────────────────────────


def _intervals(cls: frozenset) -> list[tuple[int, int]]:
    """Byte set -> sorted disjoint [lo, hi] intervals."""
    out = []
    bs = sorted(cls)
    lo = prev = bs[0]
    for b in bs[1:]:
        if b == prev + 1:
            prev = b
            continue
        out.append((lo, prev))
        lo = prev = b
    out.append((lo, prev))
    return out


# Distinct singleton classes per register before the bit-sliced membership
# plan beats per-class compare+select (bit-slicing costs <= 8 selects + 7
# ands + a 2-op constant-plane gate regardless of the letter count; the
# compare path costs ~3 ops per distinct letter).
BITSLICE_MIN = 4


def _bitslice_plan(singletons: dict[int, int]):
    """Bit-sliced membership constants for singleton classes {byte: bits}.

    Position bit j (class = the single byte b_j) must survive iff every bit
    plane of the input byte matches b_j's: m = AND_k where(bit_k(c), S_k,
    C_k), where S_k/C_k hold the position bits whose byte has plane k
    set/clear.  Planes where ALL participating bytes agree fold into one
    `(c & const_mask) == const_val` gate (for ASCII text that removes 3-4
    planes), so the per-byte cost is a handful of ops independent of how
    many distinct letters the register watches — the fix for the
    letter-union cost of alternations.
    """
    all_bits = 0
    set_planes = [0] * 8
    clear_planes = [0] * 8
    for byte, bits in singletons.items():
        all_bits |= bits
        for k in range(8):
            (set_planes if (byte >> k) & 1 else clear_planes)[k] |= bits
    const_mask = const_val = 0
    var_planes = []
    for k in range(8):
        if set_planes[k] == all_bits:
            const_mask |= 1 << k
            const_val |= 1 << k
        elif clear_planes[k] == all_bits:
            const_mask |= 1 << k
        else:
            var_planes.append((k, set_planes[k], clear_planes[k]))
    return all_bits, const_mask, const_val, tuple(var_planes)


def _smear_plan(o_mask: int) -> tuple:
    """Doubling schedule for the epsilon-smear fixed point.

    `F |= (F & O) << 1` iterated r times (r = longest optional run) is
    serial critical-path depth; the same fixed point follows from
    log2(r) doubling steps `F |= (F & T_k) << 2^k`, where T_k marks
    positions whose next 2^k positions are ALL optional (so the jump's
    intermediate landings all lie inside the run): T_0 = O,
    T_{k+1} = T_k & (T_k >> 2^k).  Returns ((shift, mask), ...).

    Masks are computed PER MACHINE (before register packing merges them):
    packed machines sit at adjacent bit offsets, and a merged-mask T_k
    could otherwise splice one machine's trailing optionals onto the next
    machine's leading ones, letting a jump cross the machine boundary."""
    plan = []
    t, d = o_mask, 1
    while t:
        plan.append((d, t))
        t = t & (t >> d)
        d *= 2
    return tuple(plan)


def _arith_fill_ok(sc) -> bool:
    """True when the epsilon smear may run as ONE arithmetic carry fill.

    Within a contiguous optional run M, the upward closure of entering bits
    t = f & M is exactly the carry-in set of the integer add M + t (the carry
    enters every position above the lowest t bit and exits one past the run
    top, then dies where M = 0):  fill = ((M + t) ^ M) ^ t.  That is 5 ops
    independent of the run length, vs 3 ops per doubling level.

    The add propagates carries through ANY contiguous run of the merged
    o_mask — including runs spliced together across a machine/segment packing
    boundary, where the doubling plan (masks computed per component) correctly
    stops.  Safe iff every adjacent optional pair lies inside one component."""
    adj = sc.o_mask & (sc.o_mask >> 1)
    internal = 0
    for cm in sc.o_runs:
        internal |= cm & (cm >> 1)
    return adj == internal


@dataclass
class _SegConsts:
    """Per-register compile-time constants of one (possibly packed) segment."""

    weights: dict          # byte-class frozenset -> position bits
    any_bits: int          # positions with class == ANY
    r_mask: int            # repeatable positions
    o_mask: int            # optional positions
    smear_plan: tuple      # ((shift, mask), ...) doubling epsilon smears
    acc_mask: int          # STICKY completion bits (last position + trailing
                           # opts of end-unanchored machines)
    start_mask: int        # always-seeded start bits (unanchored machines)
    seg_idx: int           # segment index within its machine (gap chains)
    width: int = 0         # bits used (packing watermark)
    anch_start_mask: int = 0  # start bits seeded only at the value's 1st byte
    acc_now_mask: int = 0     # NON-STICKY accept bits ('$'-anchored machines)
    o_runs: tuple = ()     # per-component o_masks BEFORE merging: the
                           # arithmetic carry fill (see _arith_fill_ok) is only
                           # safe when no optional run crosses a component
                           # (machine/segment) packing boundary


def _seg_consts(seg: Segment, base: int) -> _SegConsts:
    """Constants for `seg` with its positions placed at bit offset `base`."""
    weights: dict[frozenset, int] = {}
    any_bits = 0
    for p_idx, cls in enumerate(seg.cls):
        if cls == ANY:
            any_bits |= 1 << (base + p_idx)
            continue
        weights[cls] = weights.get(cls, 0) | (1 << (base + p_idx))
    r_mask = sum(
        1 << (base + i) for i, q in enumerate(seg.quant) if q in (Q_PLUS, Q_STAR)
    )
    o_mask = sum(
        1 << (base + i) for i, q in enumerate(seg.quant) if q in (Q_OPT, Q_STAR)
    )
    # accept mask: the last position plus the trailing optional run above it
    # (a prefix reaching any of those bits completes the segment via skips)
    acc_mask = 0
    for i in range(len(seg.cls) - 1, -1, -1):
        acc_mask |= 1 << (base + i)
        if seg.quant[i] not in (Q_OPT, Q_STAR):
            break
    return _SegConsts(weights, any_bits, r_mask, o_mask, _smear_plan(o_mask),
                      acc_mask, 1 << base, 0, base + len(seg.cls),
                      o_runs=((o_mask,) if o_mask else ()))


def _merge(a: _SegConsts, b: _SegConsts) -> _SegConsts:
    w = dict(a.weights)
    for cid, bits in b.weights.items():
        w[cid] = w.get(cid, 0) | bits
    # smear plans merge per shift distance: each mask was computed from one
    # machine's own optionals, so the union cannot splice runs across the
    # packing boundary (see _smear_plan)
    plan: dict[int, int] = dict(a.smear_plan)
    for d, m in b.smear_plan:
        plan[d] = plan.get(d, 0) | m
    return _SegConsts(w, a.any_bits | b.any_bits, a.r_mask | b.r_mask,
                      a.o_mask | b.o_mask,
                      tuple(sorted(plan.items())),
                      a.acc_mask | b.acc_mask, a.start_mask | b.start_mask, 0,
                      max(a.width, b.width),
                      a.anch_start_mask | b.anch_start_mask,
                      a.acc_now_mask | b.acc_now_mask,
                      a.o_runs + b.o_runs)


def _chunk_consts(seg: Segment) -> list[_SegConsts]:
    """Split a segment into <=MAX_POSITIONS-bit register chunks.

    Chunk k+1's entering set is fed by two carries out of chunk k (computed
    in the transition): the SHIFT carry — the old top position bit moves to
    the next chunk's bit 0 — and, when the top position is optional, the
    SMEAR carry — the post-smear entering bit skips across the boundary.
    Local smears then continue the skip within the next chunk (an optional
    run crossing the boundary re-starts its run count at bit 0, so the local
    smear count covers it).  The accept mask (last position + its trailing
    optional run) is computed over GLOBAL positions and sliced per chunk, so
    a run crossing the boundary accepts from either side."""
    n = len(seg.cls)
    acc_pos = set()
    for i in range(n - 1, -1, -1):
        acc_pos.add(i)
        if seg.quant[i] not in (Q_OPT, Q_STAR):
            break
    chunks = []
    for base in range(0, n, MAX_POSITIONS):
        sub = Segment(cls=seg.cls[base:base + MAX_POSITIONS],
                      quant=seg.quant[base:base + MAX_POSITIONS])
        sc = _seg_consts(sub, 0)
        sc.acc_mask = sum(1 << (i - base) for i in acc_pos
                          if base <= i < base + MAX_POSITIONS)
        if base:
            sc.start_mask = 0  # only chunk 0 carries the segment start bit
        chunks.append(sc)
    return chunks


@dataclass
class _MaskPlan:
    """Per-register byte-class membership plan (chosen at build time)."""

    cmp_weights: dict      # class id -> position bits (compare path)
    any_bits: int
    bslice: tuple | None   # _bitslice_plan output for singleton classes


def _mask_plan(sc: _SegConsts, class_ids, specs) -> _MaskPlan:
    """Choose the membership representation for one register's classes:
    bit-sliced planes when enough distinct single-byte classes share the
    register (cost then independent of the letter count), interval compares
    (shared program-wide per distinct class) for the rest."""
    singles: dict[int, int] = {}
    multis: dict[frozenset, int] = {}
    for cls, bits in sc.weights.items():
        if len(cls) == 1:
            (b,) = cls
            singles[b] = singles.get(b, 0) | bits
        else:
            multis[cls] = multis.get(cls, 0) | bits
    bslice = None
    if len(singles) >= BITSLICE_MIN:
        bslice = _bitslice_plan(singles)
    else:
        for b, bits in singles.items():
            key = frozenset([b])
            multis[key] = multis.get(key, 0) | bits
    cmp_weights: dict[int, int] = {}
    for cls, bits in multis.items():
        if cls not in class_ids:
            class_ids[cls] = len(specs)
            specs.append(_intervals(cls))
        cid = class_ids[cls]
        cmp_weights[cid] = cmp_weights.get(cid, 0) | bits
    return _MaskPlan(cmp_weights, sc.any_bits, bslice)


@dataclass
class _CountedMachine:
    """Lead-run counter machine (Machine.lead_run, _collapse_lead_runs)."""

    run_cid: int | None    # specs index of the run class; None = ANY
    mand: int              # counter threshold (saturation point)
    sticky: bool           # run-done feeds residual like a '.*' done bit
    res: tuple | None      # (consts, seg_offs, seg_accs) residual, or None
    anch_e: bool


@dataclass
class _MidRunMachine:
    """Interior-run counter machine (Machine.mid_run,
    _collapse_interior_runs): prefix register -> anchored counter ->
    optional suffix register."""

    pre: object            # _SegConsts of the prefix (start-seeded normally)
    run_cid: int | None    # specs index of the run class; None = ANY
    mand: int              # minimum run length
    cap: int               # maximum run length (bounded mode; 0 otherwise)
    bounded: bool
    suf: object | None     # _SegConsts of the suffix (counter-seeded) | None
    anch_e: bool


@dataclass
class _Compiled:
    """Register-compile stage shared by the per-byte and pair emitters."""

    packed: list
    fused: list
    chained: list
    packed_plans: list
    fused_plans: list
    chained_plans: list
    specs: list
    bit_planes: list
    needs_marker: bool
    n_regs: int
    counted: list = field(default_factory=list)        # _CountedMachine
    counted_plans: list = field(default_factory=list)  # _MaskPlan | None
    midrun: list = field(default_factory=list)         # _MidRunMachine
    midrun_plans: list = field(default_factory=list)   # (pre, suf|None)


def _compile_registers(prog: BitProgram) -> _Compiled:
    class_ids: dict[frozenset, int] = {}
    specs: list[list[tuple[int, int]]] = []

    packed: list[_SegConsts] = []   # shared registers of gap-free machines
    fused = []    # (consts, seg_offs, seg_accs, anch_e) per gapped machine
    chained = []  # per oversized machine: ([[chunk consts] per seg], anch_e)
    needs_marker = any(m.anch_s for m in prog.machines)
    counted: list[_CountedMachine] = []
    midrun: list[_MidRunMachine] = []

    for m in prog.machines:
        if m.mid_run is not None:
            run_cls, mand, cap, bounded = m.mid_run
            if run_cls == ANY:
                rcid = None
            else:
                if run_cls not in class_ids:
                    class_ids[run_cls] = len(specs)
                    specs.append(_intervals(run_cls))
                rcid = class_ids[run_cls]
            pre_sc = _seg_consts(m.segments[0], 0)
            suf_sc = None
            if len(m.segments) > 1:
                suf_sc = _seg_consts(m.segments[1], 0)
                suf_sc.start_mask = 0  # seeded by the counter, never freely
            midrun.append(
                _MidRunMachine(pre_sc, rcid, mand, cap, bounded, suf_sc,
                               m.anch_e))
            continue
        if m.lead_run is not None:
            run_cls, mand, sticky = m.lead_run
            if run_cls == ANY:
                rcid = None
            else:
                if run_cls not in class_ids:
                    class_ids[run_cls] = len(specs)
                    specs.append(_intervals(run_cls))
                rcid = class_ids[run_cls]
            res = None
            if m.segments:
                base = 0
                consts = None
                seg_offs, seg_accs = [], []
                for seg in m.segments:
                    sc = _seg_consts(seg, base)
                    seg_offs.append(base)
                    seg_accs.append(sc.acc_mask)
                    consts = sc if consts is None else _merge(consts, sc)
                    base += len(seg.cls)
                consts.start_mask = 0  # seeded by the counter, never freely
                res = (consts, tuple(seg_offs), tuple(seg_accs))
            counted.append(_CountedMachine(rcid, mand, sticky, res, m.anch_e))
            continue
        if len(m.segments) == 1 and len(m.segments[0].cls) <= MAX_POSITIONS:
            seg = m.segments[0]

            def _flagged(base):
                sc = _seg_consts(seg, base)
                if m.anch_s:
                    sc.anch_start_mask, sc.start_mask = sc.start_mask, 0
                if m.anch_e:
                    sc.acc_now_mask, sc.acc_mask = sc.acc_mask, 0
                return sc

            placed = False
            for slot, existing in enumerate(packed):
                if existing.width + len(seg.cls) <= MAX_POSITIONS:
                    packed[slot] = _merge(existing, _flagged(existing.width))
                    placed = True
                    break
            if not placed:
                packed.append(_flagged(0))
            continue
        total = sum(len(s.cls) for s in m.segments)
        if total <= MAX_POSITIONS:
            base = 0
            consts = None
            seg_offs, seg_accs = [], []
            for seg in m.segments:
                sc = _seg_consts(seg, base)
                seg_offs.append(base)
                seg_accs.append(sc.acc_mask)
                consts = sc if consts is None else _merge(consts, sc)
                base += len(seg.cls)
            if m.anch_s:
                consts.anch_start_mask, consts.start_mask = 1, 0
            else:
                consts.start_mask = 1
            fused.append((consts, tuple(seg_offs), tuple(seg_accs), m.anch_e))
            continue
        segs = []
        for s_idx, seg in enumerate(m.segments):
            chunks = _chunk_consts(seg)
            for sc in chunks:
                sc.seg_idx = s_idx
            if s_idx == 0 and m.anch_s:
                c0 = chunks[0]
                c0.anch_start_mask, c0.start_mask = c0.start_mask, 0
            segs.append(chunks)
        chained.append((segs, m.anch_e))

    packed_plans = [_mask_plan(sc, class_ids, specs) for sc in packed]
    fused_plans = [_mask_plan(sc, class_ids, specs) for sc, _, _, _ in fused]
    chained_plans = [
        [[_mask_plan(sc, class_ids, specs) for sc in chunks] for chunks in segs]
        for segs, _ in chained
    ]
    counted_plans = [
        _mask_plan(e.res[0], class_ids, specs) if e.res is not None else None
        for e in counted
    ]
    midrun_plans = [
        (_mask_plan(e.pre, class_ids, specs),
         _mask_plan(e.suf, class_ids, specs) if e.suf is not None else None)
        for e in midrun
    ]
    bit_planes = sorted({
        k
        for plan in (packed_plans + fused_plans
                     + [p for seg in chained_plans for ch in seg for p in ch]
                     + [p for p in counted_plans if p is not None]
                     + [p for pair in midrun_plans for p in pair
                        if p is not None])
        if plan.bslice is not None
        for k, _, _ in plan.bslice[3]
    })

    # packed groups carry a sticky accept word when any of their machines
    # accepts sticky (acceptance is sampled at the value's LAST byte, so
    # transient acc-bit hits must accumulate); '$'-anchored accepts are
    # non-sticky by definition and need no extra word.  Fused machines carry
    # (reg, done); the marker register drives '^' first-byte seeding.
    n_regs = (sum(2 if sc.acc_mask else 1 for sc in packed)
              + 2 * len(fused)
              + sum(sum(len(ch) for ch in s) + 1 for s, _ in chained)
              + sum(3 if e.res is not None else (1 if e.anch_e else 2)
                    for e in counted)
              + sum(2 + (1 if e.suf is not None else 0)
                    + (0 if e.anch_e else 1)
                    for e in midrun)
              + (1 if needs_marker else 0))
    return _Compiled(packed, fused, chained, packed_plans, fused_plans,
                     chained_plans, specs, bit_planes, needs_marker, n_regs,
                     counted, counted_plans, midrun, midrun_plans)


def make_bitprog_transition(xp, prog: BitProgram):
    """Returns (transition(state_tuple, c) -> (next_tuple, accept [N] i32),
    n_state_regs, accept_empty) — the ops/strings.py matcher interface.

    Per byte, class membership is tested once per register via the cheapest
    plan (_mask_plan): registers watching >= BITSLICE_MIN distinct letters
    use bit-sliced planes — `AND_k where(bit_k(c), S_k, C_k)` with
    always-agreeing planes folded into one constant compare — so the cost is
    ~a dozen ops regardless of the letter union; sparse registers and true
    byte classes use interval compares shared program-wide.  Then per
    register a shift/or/and ladder, an optional-run smear only where
    optionals exist, and sticky done-bit updates.  All [N] int32 vector ops;
    no gathers, no matmuls.

    Register packing: gap-free machines (single segment — e.g. the branches
    of `cat|dog|mouse`) SHARE registers, stacked at disjoint bit offsets.
    Their start positions are seeded every byte via `start_mask`, which also
    makes cross-boundary shift carries harmless (a carry can only land on an
    always-seeded start bit), so an A-way alternation of short words costs
    the same per byte as a single word.

    Machines with '.*' gaps whose total position count fits one register are
    FUSED: all segments share one register at disjoint offsets plus one done
    word, paying a single shift ladder per byte.  Segment s's start bit is
    seeded from done bit s-1 (sticky), which subsumes every cross-segment
    shift carry / optional smear: a bit can only cross the s-1 | s boundary
    out of positions inside segment s-1's acc_mask (the trailing-optional
    run plus its anchor), and any such bit set done bit s-1 on the previous
    byte — so the seed already covers the crossing.  Oversized machines keep
    the one-register-per-segment layout, and segments beyond MAX_POSITIONS
    split into carry-chained register chunks (_chunk_consts)."""
    if prog.always:
        # matches every value incl. empty: constant accept, no registers
        return (lambda state, c: ((), xp.ones_like(c))), 0, 1
    if not prog.machines:
        # every branch was an unsatisfiable inner-anchor pattern
        return (lambda state, c: ((), xp.zeros_like(c))), 0, 0
    cp = _compile_registers(prog)
    packed, fused, chained = cp.packed, cp.fused, cp.chained
    packed_plans, fused_plans = cp.packed_plans, cp.fused_plans
    chained_plans = cp.chained_plans
    counted, counted_plans = cp.counted, cp.counted_plans
    midrun, midrun_plans = cp.midrun, cp.midrun_plans
    specs, bit_planes = cp.specs, cp.bit_planes
    needs_marker, n_regs = cp.needs_marker, cp.n_regs

    def transition(state, c):
        # shared membership tests: one per distinct compare-path class, one
        # per bit plane referenced by any bit-sliced register
        tests = []
        for iv in specs:
            t = None
            for lo, hi in iv:
                m = (c == lo) if lo == hi else ((c >= lo) & (c <= hi))
                t = m if t is None else (t | m)
            tests.append(t)
        bit_tests = {k: (c & (1 << k)) != 0 for k in bit_planes}

        def byte_mask(plan: _MaskPlan):
            # OR-tree (not a serial chain): the reduction is the per-byte
            # critical path for class-heavy registers
            terms = [xp.where(tests[cid], bits, 0)
                     for cid, bits in plan.cmp_weights.items()]
            if plan.bslice is not None:
                all_bits, cmask, cval, var = plan.bslice
                if var:
                    # AND-tree, not a serial chain: keeps the step's
                    # critical-path depth at log2(planes) levels
                    sels = [xp.where(bit_tests[k], s_bits, c_bits)
                            for k, s_bits, c_bits in var]
                    while len(sels) > 1:
                        nxt = [sels[i] & sels[i + 1]
                               for i in range(0, len(sels) - 1, 2)]
                        if len(sels) % 2:
                            nxt.append(sels[-1])
                        sels = nxt
                    m = sels[0]
                else:
                    m = xp.full_like(c, all_bits)
                if cmask:
                    m = xp.where((c & cmask) == cval, m, 0)
                terms.append(m)
            if plan.any_bits:
                terms.append(xp.full_like(c, plan.any_bits))
            if not terms:
                return xp.zeros_like(c)
            while len(terms) > 1:
                nxt = [terms[i] | terms[i + 1]
                       for i in range(0, len(terms) - 1, 2)]
                if len(terms) % 2:
                    nxt.append(terms[-1])
                terms = nxt
            return terms[0]

        def advance(sc: _SegConsts, plan: _MaskPlan, reg, seed, clear=0):
            # `clear` strips shift/smear carries INTO '^'-anchored start
            # bits (their only legitimate activation is the first-byte seed;
            # unanchored start bits are always-seeded, so carries onto them
            # are subsumed and need no clearing).  Returns (next register,
            # post-smear entering set) — wide chunks read the entering set
            # for their cross-register smear carry.
            f = reg << 1
            if clear:
                f = f & ~clear
            f = f | seed
            if len(sc.smear_plan) >= 2 and _arith_fill_ok(sc):
                # arithmetic carry fill: constant 5 ops vs 3/doubling level
                # (_arith_fill_ok proves no run crosses a component boundary;
                # a `clear` bit inside a run would also cross one, so a single
                # post-fill clear matches the per-level doubling clears)
                m = sc.o_mask
                t = f & m
                inc = ((m + t) ^ m) ^ t
                if clear:
                    inc = inc & ~clear
                f = f | inc
            else:
                for d, m in sc.smear_plan:
                    inc = (f & m) << d
                    if clear:
                        inc = inc & ~clear
                    f = f | inc
            b = byte_mask(plan)
            nxt = f & b
            if sc.r_mask:
                nxt = nxt | (reg & sc.r_mask & b)
            return nxt, f

        new_state = []
        accept = None

        def acc_or(v):
            nonlocal accept
            accept = v if accept is None else (accept | v)

        if needs_marker:
            first_b = state[-1] == 0  # the value's first byte (control_update
            first_i = first_b.astype(xp.int32)  # zeroes state at boundaries)

        reg_at = 0
        for sc, plan in zip(packed, packed_plans):
            seed = sc.start_mask
            clear = 0
            if sc.anch_start_mask:
                aseed = xp.where(first_b, sc.anch_start_mask, 0)
                seed = (aseed | seed) if seed else aseed
                clear = sc.anch_start_mask & ~1
            reg, _ = advance(sc, plan, state[reg_at], seed, clear)
            reg_at += 1
            new_state.append(reg)
            cur = None
            if sc.acc_mask:
                sticky = state[reg_at] | (reg & sc.acc_mask)
                reg_at += 1
                new_state.append(sticky)
                cur = sticky
            if sc.acc_now_mask:
                now = reg & sc.acc_now_mask
                cur = now if cur is None else (cur | now)
            acc_or((cur != 0).astype(xp.int32))
        for (sc, seg_offs, seg_accs, anch_e), plan in zip(fused, fused_plans):
            old_reg, done = state[reg_at], state[reg_at + 1]
            reg_at += 2
            seed = first_i if sc.anch_start_mask else 1
            for s in range(1, len(seg_offs)):
                seed = seed | (((done >> (s - 1)) & 1) << seg_offs[s])
            reg, _ = advance(sc, plan, old_reg, seed)
            new_done = done
            last_hit = None
            for s, acc_mask in enumerate(seg_accs):
                hit = ((reg & acc_mask) != 0).astype(xp.int32)
                new_done = new_done | (hit << s)
                last_hit = hit
            acc_or(last_hit if anch_e
                   else ((new_done >> (len(seg_accs) - 1)) & 1))
            new_state.append(reg)
            new_state.append(new_done)
        for (segs, anch_e), plans in zip(chained, chained_plans):
            n_chunk_regs = sum(len(ch) for ch in segs)
            regs = state[reg_at : reg_at + n_chunk_regs]
            done = state[reg_at + n_chunk_regs]
            reg_at += n_chunk_regs + 1
            new_done = done
            last_hit = None
            r = 0
            for s_idx, (chunks, cplans) in enumerate(zip(segs, plans)):
                if s_idx == 0:
                    seed = first_i if chunks[0].anch_start_mask else 1
                else:
                    seed = (done >> (s_idx - 1)) & 1
                hit = None
                prev_old = prev_f = prev_sc = None
                for c_idx, (sc, plan) in enumerate(zip(chunks, cplans)):
                    old = regs[r]
                    r += 1
                    if c_idx:
                        # carries across the register boundary: the old top
                        # position shifts into bit 0; a post-smear entering
                        # bit on an optional top position skips across too
                        top = prev_sc.width - 1
                        carry = (prev_old >> top) & 1
                        if prev_sc.o_mask & (1 << top):
                            carry = carry | ((prev_f >> top) & 1)
                        seed_c = carry
                    else:
                        seed_c = seed
                    nxt, f = advance(sc, plan, old, seed_c)
                    if sc.acc_mask:
                        h = ((nxt & sc.acc_mask) != 0).astype(xp.int32)
                        hit = h if hit is None else (hit | h)
                    new_state.append(nxt)
                    prev_old, prev_f, prev_sc = old, f, sc
                new_done = new_done | (hit << s_idx)
                if s_idx == len(segs) - 1:
                    last_hit = hit
            acc_or(last_hit if anch_e else ((new_done >> (len(segs) - 1)) & 1))
            new_state.append(new_done)
        for ent, plan in zip(counted, counted_plans):
            # lead-run counter machine: cnt = saturating streak of run-class
            # bytes (value-boundary resets zero it like any register)
            cnt = state[reg_at]
            reg_at += 1
            inc = cnt + (cnt < ent.mand).astype(xp.int32)
            new_cnt = (inc if ent.run_cid is None
                       else xp.where(tests[ent.run_cid], inc, 0))
            new_state.append(new_cnt)
            hit_now = (new_cnt >= ent.mand).astype(xp.int32)
            if ent.res is None:
                if ent.anch_e:
                    acc_or(hit_now)  # run must END at the value's last byte
                else:
                    stick = state[reg_at] | hit_now
                    reg_at += 1
                    new_state.append(stick)
                    acc_or(stick)
                continue
            sc, seg_offs, seg_accs = ent.res
            old_reg, done = state[reg_at], state[reg_at + 1]
            reg_at += 2
            # done bit 0 = run-done (sticky machines only: run was segment 0
            # entirely, so it seeds like a '.*' done bit); residual segment s
            # owns done bit s+1.  Non-sticky: the residual's first position
            # must start the byte right after the streak — seed it from the
            # LIVE counter (run through the previous byte) instead.
            seed = (done & 1) if ent.sticky else (cnt >= ent.mand).astype(
                xp.int32)
            for s in range(1, len(seg_offs)):
                seed = seed | (((done >> s) & 1) << seg_offs[s])
            reg, _ = advance(sc, plan, old_reg, seed)
            new_done = (done | hit_now) if ent.sticky else done
            last_hit = None
            for s, acc_mask in enumerate(seg_accs):
                hit = ((reg & acc_mask) != 0).astype(xp.int32)
                new_done = new_done | (hit << (s + 1))
                last_hit = hit
            acc_or(last_hit if ent.anch_e
                   else ((new_done >> len(seg_accs)) & 1))
            new_state.append(reg)
            new_state.append(new_done)
        for ent, (pre_plan, suf_plan) in zip(midrun, midrun_plans):
            # interior-run counter machine: prefix register -> anchored
            # counter -> suffix register (_collapse_interior_runs).  All
            # three pieces read LAST byte's state, so their updates are
            # independent dataflow within the step:
            #   p_prev  = prefix accept through the PREVIOUS byte
            #   counter = run-class streak since its anchor (0 = inactive);
            #             saturates at cap+1 (bounded: counts past the
            #             window disable the seed) or mand (unbounded)
            #   suffix  = seeded from the LIVE counter window, exactly like
            #             the lead-run residual
            pre_reg = state[reg_at]
            cnt = state[reg_at + 1]
            reg_at += 2
            p_prev = ((pre_reg & ent.pre.acc_mask) != 0).astype(xp.int32)
            hit_now = None
            new_suf = None
            if ent.suf is not None:
                seed_ok = cnt >= ent.mand
                if ent.bounded:
                    seed_ok = seed_ok & (cnt <= ent.cap)
                suf_old = state[reg_at]
                reg_at += 1
                sreg, _ = advance(ent.suf, suf_plan, suf_old,
                                  seed_ok.astype(xp.int32))
                hit_now = ((sreg & ent.suf.acc_mask) != 0).astype(xp.int32)
                new_suf = sreg
            cap_sat = (ent.cap + 1) if ent.bounded else ent.mand
            inc = cnt + (cnt < cap_sat).astype(xp.int32)
            active = xp.where(cnt > 0, inc, p_prev)
            new_cnt = (active if ent.run_cid is None
                       else xp.where(tests[ent.run_cid], active, 0))
            if ent.suf is None:
                ok = new_cnt >= ent.mand
                if ent.bounded:
                    ok = ok & (new_cnt <= ent.cap)
                hit_now = ok.astype(xp.int32)
            new_pre, _ = advance(ent.pre, pre_plan, pre_reg,
                                 ent.pre.start_mask)
            new_state.append(new_pre)
            new_state.append(new_cnt)
            if new_suf is not None:
                new_state.append(new_suf)
            if ent.anch_e:
                acc_or(hit_now)
            else:
                stick = state[reg_at] | hit_now
                reg_at += 1
                new_state.append(stick)
                acc_or(stick)

        if needs_marker:
            new_state.append(xp.ones_like(c))
        return tuple(new_state), accept

    return transition, n_regs, 0


# ── 2-bytes-per-step composed transitions ───────────────────────────────────
# Each lax.scan step of the streaming walk pays the dependent-op chain of
# one byte.  For the no-smear register family (chains, classes, self-loop
# repeats, '.*' gaps, anchors) the two-byte composition collapses to the
# same chain DEPTH as one byte — every per-byte operator is linear over the
# bit-OR semiring with byte-dependent constant masks, so
#
#   T2(T1(x)) = (x<<2)&M2 | (x<<1)&M1 | x&M0 | C
#
# with M2/M1/M0/C precomputable off the x-critical-path (M1/M0 only when
# self-loops exist).  Fused '.*' machines compose too: seeding segment s at
# byte 2 from done AFTER byte 1 = seeding from done BEFORE byte 1 (the
# sticky word is one byte stale — harmless) OR from segment s-1's accept at
# byte 1 — and the latter is exactly the natural shift carry bit
# (off_s - 1) -> off_s already inside M2, because single-bit accepts sit
# directly below the next segment's first position.  Optional-run smears do
# NOT compose this way (the smear spread squares per byte), so machines with
# o_mask fall back to the per-byte transition.
#
# The value-boundary gating (state freezes on prefix bytes, resets when a
# prefix completes) moves INSIDE the composed transition: per byte the
# effective map is E_i(x) = sel(pd_i, 0, sel(ip_i, x, T_i(x))), and
# E2(E1(x)) expands over the selects into candidates {0, E1, T2(0), T2(x),
# T12(x)} — three selects after the composed ladder.


def pair_supported(prog: BitProgram) -> bool:
    """True when every machine compiles to packed or fused registers with
    no optional positions — the family `make_bitprog_transition_pair`
    covers."""
    for m in prog.machines:
        if m.lead_run is not None or m.mid_run is not None:
            return False          # counter machines: per-byte only
        total = sum(len(s.cls) for s in m.segments)
        if total > MAX_POSITIONS:
            return False          # chained/wide registers: per-byte only
        for seg in m.segments:
            if any(q in (Q_OPT, Q_STAR) for q in seg.quant):
                return False      # optional smears: per-byte only
    return True


def _byte_mask_for(xp, plan: _MaskPlan, c, tests, bit_tests):
    """byte_mask against explicit per-byte test tables (pair emitter)."""
    terms = [xp.where(tests[cid], bits, 0)
             for cid, bits in plan.cmp_weights.items()]
    if plan.bslice is not None:
        all_bits, cmask, cval, var = plan.bslice
        if var:
            sels = [xp.where(bit_tests[k], s_bits, c_bits)
                    for k, s_bits, c_bits in var]
            while len(sels) > 1:
                nxt = [sels[i] & sels[i + 1]
                       for i in range(0, len(sels) - 1, 2)]
                if len(sels) % 2:
                    nxt.append(sels[-1])
                sels = nxt
            m = sels[0]
        else:
            m = xp.full_like(c, all_bits)
        if cmask:
            m = xp.where((c & cmask) == cval, m, 0)
        terms.append(m)
    if plan.any_bits:
        terms.append(xp.full_like(c, plan.any_bits))
    if not terms:
        return xp.zeros_like(c)
    while len(terms) > 1:
        nxt = [terms[i] | terms[i + 1] for i in range(0, len(terms) - 1, 2)]
        if len(terms) % 2:
            nxt.append(terms[-1])
        terms = nxt
    return terms[0]


def make_bitprog_transition_pair(xp, prog: BitProgram):
    """Returns (transition2, n_state_regs, accept_empty) where
    transition2(state, c1, c2, pd1, ip1, pd2, ip2) -> (next_state, acc1,
    acc2) advances TWO bytes with the boundary gating folded in (pd_i =
    prefix completes at byte i -> state resets AFTER it; ip_i = byte i is
    a prefix byte -> state freezes).  acc_i is the accept candidate after
    byte i, valid when byte i ends a value (the caller samples it under
    fin_i).  Raises BitprogUnsupported outside the no-smear packed/fused
    family — callers fall back to the per-byte transition."""
    if prog.always:
        def always2(state, c1, c2, pd1, ip1, pd2, ip2):
            return (), xp.ones_like(c1), xp.ones_like(c2)
        return always2, 0, 1
    if not prog.machines:
        def never2(state, c1, c2, pd1, ip1, pd2, ip2):
            return (), xp.zeros_like(c1), xp.zeros_like(c2)
        return never2, 0, 0
    if not pair_supported(prog):
        raise BitprogUnsupported("pair mode: smears or wide registers")
    cp = _compile_registers(prog)
    if cp.chained:
        raise BitprogUnsupported("pair mode: chained registers")

    def transition2(state, c1, c2, pd1, ip1, pd2, ip2):
        def tests_for(c):
            tests = []
            for iv in cp.specs:
                t = None
                for lo, hi in iv:
                    m = (c == lo) if lo == hi else ((c >= lo) & (c <= hi))
                    t = m if t is None else (t | m)
                tests.append(t)
            bit_tests = {k: (c & (1 << k)) != 0 for k in cp.bit_planes}
            return tests, bit_tests

        t1, bt1 = tests_for(c1)
        t2, bt2 = tests_for(c2)

        def gate1(old, new):
            return xp.where(pd1, 0, xp.where(ip1, old, new))

        def gate2(old, new):
            return xp.where(pd2, 0, xp.where(ip2, old, new))

        new_state = []
        acc1 = None
        acc2 = None

        def acc_or(i1, i2):
            nonlocal acc1, acc2
            acc1 = i1 if acc1 is None else (acc1 | i1)
            acc2 = i2 if acc2 is None else (acc2 | i2)

        if cp.needs_marker:
            m0 = state[-1]
            first1 = m0 == 0   # control_update zeroes state at boundaries
            first2 = pd1 | (ip1 & first1)
            first1_i = first1.astype(xp.int32)
            first2_i = first2.astype(xp.int32)

        reg_at = 0
        for sc, plan in zip(cp.packed, cp.packed_plans):
            x = state[reg_at]
            reg_at += 1
            b1 = _byte_mask_for(xp, plan, c1, t1, bt1)
            b2 = _byte_mask_for(xp, plan, c2, t2, bt2)
            cl = sc.anch_start_mask & ~1 if sc.anch_start_mask else 0
            bs1 = b1 & ~cl if cl else b1
            bs2 = b2 & ~cl if cl else b2
            # seeds (reg-independent): always-on start bits + first-byte
            # anchored bits
            s1 = sc.start_mask
            s2 = sc.start_mask
            if sc.anch_start_mask:
                a1 = xp.where(first1, sc.anch_start_mask, 0)
                a2 = xp.where(first2, sc.anch_start_mask, 0)
                s1 = (s1 | a1) if s1 else a1
                s2 = (s2 | a2) if s2 else a2
            sb1 = s1 & b1
            sb2 = s2 & b2
            r = sc.r_mask
            # single-byte candidates
            T1x = ((x << 1) & bs1) | sb1
            T2x = ((x << 1) & bs2) | sb2
            if r:
                T1x = T1x | (x & (b1 & r))
                T2x = T2x | (x & (b2 & r))
            # composed two-byte candidate
            M2 = (bs1 << 1) & bs2
            C = ((sb1 << 1) & bs2) | sb2
            T12x = ((x << 2) & M2) | C
            if r:
                rb1 = b1 & r
                rb2 = b2 & r
                M1 = ((rb1 << 1) & bs2) | (bs1 & rb2)
                M0 = rb1 & rb2
                T12x = T12x | ((x << 1) & M1) | (x & M0) | (sb1 & rb2)
            E1 = gate1(x, T1x)
            T2E1 = xp.where(pd1, sb2, xp.where(ip1, T2x, T12x))
            out = gate2(E1, T2E1)
            new_state.append(out)

            cur1 = cur2 = None
            if sc.acc_mask:
                st0 = state[reg_at]
                reg_at += 1
                st_T1 = st0 | (T1x & sc.acc_mask)
                stE1 = gate1(st0, st_T1)
                st_T2 = stE1 | (T2E1 & sc.acc_mask)
                new_state.append(gate2(stE1, st_T2))
                cur1, cur2 = st_T1, st_T2
            if sc.acc_now_mask:
                now1 = T1x & sc.acc_now_mask
                now2 = T2E1 & sc.acc_now_mask
                cur1 = now1 if cur1 is None else (cur1 | now1)
                cur2 = now2 if cur2 is None else (cur2 | now2)
            acc_or((cur1 != 0).astype(xp.int32),
                   (cur2 != 0).astype(xp.int32))

        for (sc, seg_offs, seg_accs, anch_e), plan in zip(cp.fused,
                                                          cp.fused_plans):
            x, done0 = state[reg_at], state[reg_at + 1]
            reg_at += 2
            b1 = _byte_mask_for(xp, plan, c1, t1, bt1)
            b2 = _byte_mask_for(xp, plan, c2, t2, bt2)
            # seeds: segment 0 start (always or first-byte-anchored) +
            # done-driven segment seeds from done BEFORE the pair.  At byte
            # 2 the stale done is completed by the natural shift carry
            # (off_s - 1) -> off_s inside the composed mask (accepts are
            # single bits in the no-smear family).
            base1 = first1_i if sc.anch_start_mask else 1
            base2 = first2_i if sc.anch_start_mask else 1
            dseed = 0
            for s in range(1, len(seg_offs)):
                dseed = dseed | (((done0 >> (s - 1)) & 1) << seg_offs[s])
            s1 = base1 | dseed
            s2 = base2 | dseed
            sb1 = s1 & b1
            sb2 = s2 & b2
            T1x = ((x << 1) & b1) | sb1
            T2x = ((x << 1) & b2) | sb2
            M2 = (b1 << 1) & b2
            T12x = ((x << 2) & M2) | ((sb1 << 1) & b2) | sb2
            # reset case (pd1): register AND done are zeroed before byte 2,
            # so only the base seed applies
            T20 = base2 & b2
            E1 = gate1(x, T1x)
            T2E1 = xp.where(pd1, T20, xp.where(ip1, T2x, T12x))
            out = gate2(E1, T2E1)
            new_state.append(out)

            d_T1 = done0
            last1 = None
            for s, am in enumerate(seg_accs):
                h = ((T1x & am) != 0).astype(xp.int32)
                d_T1 = d_T1 | (h << s)
                last1 = h
            dE1 = gate1(done0, d_T1)
            d_T2 = dE1
            last2 = None
            for s, am in enumerate(seg_accs):
                h = ((T2E1 & am) != 0).astype(xp.int32)
                d_T2 = d_T2 | (h << s)
                last2 = h
            new_state.append(gate2(dE1, d_T2))
            ns = len(seg_accs)
            acc_or(last1 if anch_e else ((d_T1 >> (ns - 1)) & 1),
                   last2 if anch_e else ((d_T2 >> (ns - 1)) & 1))

        if cp.needs_marker:
            ones = xp.ones_like(c1)
            mE1 = gate1(m0, ones)
            new_state.append(gate2(mE1, ones))
        return tuple(new_state), acc1, acc2

    return transition2, cp.n_regs, 0
