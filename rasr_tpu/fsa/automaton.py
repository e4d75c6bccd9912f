"""Weighted finite-state automata (host side).

Re-implements the reference's FSA core (ref: src/Fsa/ — Fsa::Automaton
with pluggable semirings, Fsa::StaticAutomaton, ATT text I/O). The
reference builds *lazy* on-demand automata because its decoders traverse
them frame by frame; in this framework automata only serve host-side
model preparation and lattice post-processing (the device paths use
compiled dense arrays), so a small eager representation is the right
tool. Epsilon is label 0, as in the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Tuple

EPS = 0


class Semiring:
    """Abstract semiring (ref: Fsa::Semiring)."""

    one: float
    zero: float

    @staticmethod
    def plus(a: float, b: float) -> float:  # pragma: no cover - interface
        raise NotImplementedError

    @staticmethod
    def times(a: float, b: float) -> float:
        return a + b  # both tropical and log use +


class Tropical(Semiring):
    """min/+ over -log weights (ref: tropical semiring)."""

    one = 0.0
    zero = math.inf

    @staticmethod
    def plus(a: float, b: float) -> float:
        return min(a, b)


class LogSemiring(Semiring):
    """-log(e^-a + e^-b) / + (ref: log semiring)."""

    one = 0.0
    zero = math.inf

    @staticmethod
    def plus(a: float, b: float) -> float:
        if a == math.inf:
            return b
        if b == math.inf:
            return a
        m = min(a, b)
        return m - math.log1p(math.exp(-abs(a - b)))


@dataclasses.dataclass
class Arc:
    target: int
    ilabel: int
    olabel: int
    weight: float


class Automaton:
    """Eager weighted transducer (acceptor when ilabel==olabel)."""

    def __init__(self, semiring: type = Tropical):
        self.semiring = semiring
        self.arcs: List[List[Arc]] = []
        self.finals: Dict[int, float] = {}
        self.initial: int = -1
        self.input_symbols: Dict[int, str] = {EPS: "<eps>"}
        self.output_symbols: Dict[int, str] = {EPS: "<eps>"}

    # ------------------------------------------------------------- building
    def add_state(self) -> int:
        self.arcs.append([])
        return len(self.arcs) - 1

    def add_arc(self, source: int, target: int, ilabel: int, olabel: Optional[int] = None, weight: float = 0.0) -> None:
        self.arcs[source].append(
            Arc(target, ilabel, ilabel if olabel is None else olabel, weight)
        )

    def set_final(self, state: int, weight: float = 0.0) -> None:
        self.finals[state] = weight

    @property
    def num_states(self) -> int:
        return len(self.arcs)

    @property
    def num_arcs(self) -> int:
        return sum(len(a) for a in self.arcs)

    def is_final(self, state: int) -> bool:
        return state in self.finals

    # ------------------------------------------------------------ utilities
    def copy(self) -> "Automaton":
        out = Automaton(self.semiring)
        out.arcs = [[dataclasses.replace(a) for a in arcs] for arcs in self.arcs]
        out.finals = dict(self.finals)
        out.initial = self.initial
        out.input_symbols = dict(self.input_symbols)
        out.output_symbols = dict(self.output_symbols)
        return out

    @classmethod
    def from_string(cls, labels: Iterable[int], semiring: type = Tropical) -> "Automaton":
        """Linear acceptor for a label sequence."""
        fsa = cls(semiring)
        cur = fsa.add_state()
        fsa.initial = cur
        for lab in labels:
            nxt = fsa.add_state()
            fsa.add_arc(cur, nxt, lab)
            cur = nxt
        fsa.set_final(cur)
        return fsa

    def accepts_cost(self, labels: List[int]) -> float:
        """Cost of the best path accepting `labels` (inf if rejected).
        Brute-force for tests; assumes no input-eps cycles with gain."""
        sr = self.semiring
        if self.initial < 0 or self.initial >= self.num_states:
            return math.inf  # empty automaton accepts nothing
        # states reachable consuming prefix; dict state->cost
        frontier = {self.initial: sr.one}
        frontier = self._eps_closure(frontier)
        for lab in labels:
            nxt: Dict[int, float] = {}
            for s, c in frontier.items():
                for a in self.arcs[s]:
                    if a.ilabel == lab:
                        w = sr.times(c, a.weight)
                        nxt[a.target] = sr.plus(nxt.get(a.target, sr.zero), w)
            frontier = self._eps_closure(nxt)
            if not frontier:
                return math.inf
        best = sr.zero
        for s, c in frontier.items():
            if s in self.finals:
                best = sr.plus(best, sr.times(c, self.finals[s]))
        return best

    def _eps_closure(self, frontier: Dict[int, float]) -> Dict[int, float]:
        sr = self.semiring
        out = dict(frontier)
        stack = list(frontier)
        while stack:
            s = stack.pop()
            for a in self.arcs[s]:
                if a.ilabel == EPS:
                    w = sr.times(out[s], a.weight)
                    old = out.get(a.target, sr.zero)
                    new = sr.plus(old, w)
                    if new < old - 1e-12 or a.target not in out:
                        out[a.target] = new
                        stack.append(a.target)
        return out

    # ---------------------------------------------------------------- att io
    def write_att(self, path: str) -> None:
        """AT&T text format (ref: Fsa ATT I/O)."""
        with open(path, "w", encoding="utf-8") as fh:
            for s in range(self.num_states):
                for a in self.arcs[s]:
                    fh.write(f"{s}\t{a.target}\t{a.ilabel}\t{a.olabel}\t{a.weight}\n")
            for s, w in self.finals.items():
                fh.write(f"{s}\t{w}\n")

    @classmethod
    def read_att(cls, path: str, semiring: type = Tropical) -> "Automaton":
        fsa = cls(semiring)
        max_state = -1
        arcs = []
        finals = {}
        with open(path, "r", encoding="utf-8") as fh:
            for line in fh:
                parts = line.split()
                if not parts:
                    continue
                if len(parts) >= 4:
                    s, t, il, ol = int(parts[0]), int(parts[1]), int(parts[2]), int(parts[3])
                    w = float(parts[4]) if len(parts) > 4 else 0.0
                    arcs.append((s, t, il, ol, w))
                    max_state = max(max_state, s, t)
                else:
                    s = int(parts[0])
                    w = float(parts[1]) if len(parts) > 1 else 0.0
                    finals[s] = w
                    max_state = max(max_state, s)
        for _ in range(max_state + 1):
            fsa.add_state()
        for s, t, il, ol, w in arcs:
            fsa.add_arc(s, t, il, ol, w)
        fsa.finals = finals
        fsa.initial = 0
        return fsa

    def draw_dot(self) -> str:
        """Graphviz dot text (ref: Fsa drawing support)."""
        lines = ["digraph fsa {", "rankdir=LR;"]
        for s in range(self.num_states):
            shape = "doublecircle" if s in self.finals else "circle"
            lines.append(f'  {s} [shape={shape}];')
            for a in self.arcs[s]:
                il = self.input_symbols.get(a.ilabel, str(a.ilabel))
                ol = self.output_symbols.get(a.olabel, str(a.olabel))
                lab = il if a.ilabel == a.olabel else f"{il}:{ol}"
                lines.append(f'  {s} -> {a.target} [label="{lab}/{a.weight:.3g}"];')
        lines.append("}")
        return "\n".join(lines)
