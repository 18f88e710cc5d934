"""Synthetic MMLU-style prompt generator (paper §5.1), copied from
``repro.data.mmlu``.

Reproduces the *structure* that the paper's evaluation relies on:
within a domain every prompt shares the instruction and the
few-shot examples, while the target question varies. Text is generated
from seeded word pools, offline. The seeds come from Python's ``hash()``
of the domain, as in the reference: the same within a process, and from
one process to the next only under a fixed ``PYTHONHASHSEED``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from repro_torch.core.segments import PromptSegments
from repro_torch.data.tokenizer import WordHashTokenizer

MMLU_DOMAINS = [
    "abstract_algebra", "anatomy", "astronomy", "business_ethics",
    "clinical_knowledge", "college_biology", "college_chemistry",
    "college_computer_science", "college_mathematics", "college_medicine",
    "college_physics", "computer_security", "conceptual_physics",
    "econometrics", "electrical_engineering", "elementary_mathematics",
    "formal_logic", "global_facts", "high_school_biology",
    "high_school_chemistry", "high_school_computer_science",
    "high_school_european_history", "high_school_geography",
    "high_school_government_and_politics", "high_school_macroeconomics",
    "high_school_mathematics", "high_school_microeconomics",
    "high_school_physics", "high_school_psychology",
    "high_school_statistics", "high_school_us_history",
    "high_school_world_history", "human_aging", "human_sexuality",
    "international_law", "jurisprudence", "logical_fallacies",
    "machine_learning", "management", "marketing", "medical_genetics",
    "miscellaneous", "moral_disputes", "moral_scenarios", "nutrition",
    "philosophy", "prehistory", "professional_accounting",
    "professional_law", "professional_medicine", "professional_psychology",
    "public_relations", "security_studies", "sociology",
    "us_foreign_policy", "virology", "world_religions",
]

_WORDS = ("the of and to in is that it for on with as are this be at or "
          "from by not have but they which one all were when we there can "
          "an your what some other than then now only its over also after "
          "first two new more these may like most between state value "
          "system theory model result method problem answer question "
          "number function energy force field matter space time light "
          "cell gene protein market price cost law court right duty").split()


@dataclass
class MMLUPrompt:
    domain: str
    segments: PromptSegments
    instruction_len: int
    example_lens: List[int]
    answer: str


class MMLUGenerator:
    def __init__(self, tokenizer: WordHashTokenizer, n_shot: int = 5,
                 seed: int = 0, question_words: tuple = (24, 48),
                 example_words: tuple = (24, 48)):
        self.tok = tokenizer
        self.n_shot = n_shot
        self.seed = seed
        self.qw = question_words
        self.ew = example_words

    def _sentence(self, rng, lo, hi) -> str:
        n = int(rng.integers(lo, hi + 1))
        return " ".join(rng.choice(_WORDS) for _ in range(n))

    def _domain_rng(self, domain: str):
        return np.random.default_rng(
            (hash(domain) ^ self.seed) & 0x7FFFFFFF)

    def instruction(self, domain: str) -> str:
        return (f"The following are multiple choice questions with answers "
                f"about {domain.replace('_', ' ')} . Choose A B C or D .")

    def examples(self, domain: str) -> List[str]:
        rng = self._domain_rng(domain)
        out = []
        for i in range(self.n_shot):
            q = self._sentence(rng, *self.ew)
            a = rng.choice(["A", "B", "C", "D"])
            out.append(f"Question : {q} ? Answer : {a} .")
        return out

    def prompt(self, domain: str, question_idx: int) -> MMLUPrompt:
        rng = np.random.default_rng(
            (hash((domain, question_idx)) ^ self.seed) & 0x7FFFFFFF)
        instr_ids = self.tok.encode(self.instruction(domain))
        ex_ids = [self.tok.encode(e, bos=False)
                  for e in self.examples(domain)]
        q = self._sentence(rng, *self.qw)
        q_ids = self.tok.encode(f"Question : {q} ? Answer :", bos=False)
        token_ids = list(instr_ids)
        example_lens = []
        for e in ex_ids:
            token_ids.extend(e)
            example_lens.append(len(e))
        token_ids.extend(q_ids)
        seg = PromptSegments.mmlu_style(token_ids, len(instr_ids),
                                        example_lens)
        return MMLUPrompt(domain=domain, segments=seg,
                          instruction_len=len(instr_ids),
                          example_lens=example_lens,
                          answer=str(rng.choice(list("ABCD"))))

    def stream(self, n_prompts: int, domains: Sequence[str] = None):
        """Round-robin over domains — the paper's 6434-prompt workload."""
        domains = list(domains or MMLU_DOMAINS)
        for i in range(n_prompts):
            yield self.prompt(domains[i % len(domains)], i // len(domains))
