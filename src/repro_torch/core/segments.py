"""Prompt structure and partial-matching ranges (paper §3.2, Figure 3).

A copy of ``repro.core.segments``. A prompt's boundaries (instruction /
few-shot examples / question) give up to ``max_ranges`` prefix ranges,
registered on upload and probed longest first on lookup.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

from repro_torch.core.keys import PromptKey


@dataclass(frozen=True)
class PromptSegments:
    token_ids: tuple               # full prompt token ids
    boundaries: tuple              # ascending token counts of logical prefixes

    @classmethod
    def make(cls, token_ids: Sequence[int], boundaries: Sequence[int]):
        n = len(token_ids)
        bs = sorted({min(b, n) for b in boundaries if b > 0} | {n})
        return cls(tuple(int(t) for t in token_ids), tuple(bs))

    @classmethod
    def mmlu_style(cls, token_ids: Sequence[int], instruction_len: int,
                   example_lens: Sequence[int]):
        """Paper Figure 3: instruction | N examples | question."""
        bounds = [instruction_len]
        if example_lens:
            bounds.append(instruction_len + example_lens[0])
            bounds.append(instruction_len + sum(example_lens))
        bounds.append(len(token_ids))
        return cls.make(token_ids, bounds)

    def ranges(self, max_ranges: int = 4, stride: int = 0) -> List[int]:
        """Prefix lengths to register/probe, longest first. ``stride`` > 0
        also registers every ``stride``-th token boundary."""
        n = len(self.token_ids)
        if stride > 0:
            bs = sorted(set(list(self.boundaries)
                            + list(range(stride, n, stride)) + [n]))
            return bs[::-1]
        bs = list(self.boundaries)
        if len(bs) > max_ranges:
            # always keep the shortest (instruction) and the full prompt
            keep = [bs[0]] + bs[-(max_ranges - 1):]
            bs = sorted(set(keep))
        return bs[::-1]

    def keys(self, meta: bytes, max_ranges: int = 4,
             stride: int = 0) -> List[PromptKey]:
        return [PromptKey.for_prefix(meta, self.token_ids, n)
                for n in self.ranges(max_ranges, stride)]
