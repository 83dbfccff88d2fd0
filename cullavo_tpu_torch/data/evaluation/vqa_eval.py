"""VQA accuracy evaluation — semantics of the official VQA tool.

Capability parity with the vendored evaluator the reference uses
(cullavo/eval/vqav2/vqa.py:23-160, vqaEval.py:11-380 and
datasets/evaluation/vqa_evaluation.py:65-118): the 10-annotator consensus
accuracy ``mean_j min(#{matches among the other 9}/3, 1)`` with the standard
answer normalization (contraction expansion, punctuation stripping with the
digit-comma/period rules, number-word→digit mapping, article removal).

The normalization tables (contractions, number words, articles, punctuation)
are the public VQA-tool constants, stored as data in
``vqa_norm_tables.json``.  Fresh implementation, plus per-question-type /
answer-type buckets and the results-JSON writer format the pipelines expect.
"""
from __future__ import annotations

import json
import os
import re
from collections import defaultdict

_HERE = os.path.dirname(__file__)

with open(os.path.join(_HERE, "vqa_norm_tables.json")) as _f:
    _T = json.load(_f)

CONTRACTIONS: dict = _T["contractions"]
MANUAL_MAP: dict = _T["manual_map"]
ARTICLES: list = _T["articles"]
PUNCT: list = _T["punct"]
PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
COMMA_STRIP = re.compile(r"(\d)(\,)(\d)")


def process_punctuation(text: str) -> str:
    out = text
    for p in PUNCT:
        if (p + " " in text or " " + p in text) or (COMMA_STRIP.search(text) is not None):
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    return PERIOD_STRIP.sub("", out, re.UNICODE)


def process_digit_article(text: str) -> str:
    out = []
    for word in text.lower().split():
        word = MANUAL_MAP.get(word, word)
        if word not in ARTICLES:
            out.append(word)
    for i, word in enumerate(out):
        if word in CONTRACTIONS:
            out[i] = CONTRACTIONS[word]
    return " ".join(out)


def normalize_answer(ans: str) -> str:
    ans = ans.replace("\n", " ").replace("\t", " ").strip()
    return process_digit_article(process_punctuation(ans))


class VQAEvaluator:
    """Accumulates (answer, gt_answers) pairs; computes the consensus accuracy.

    ``gt_answers``: the 10 annotator answers for the question.  Buckets by
    question type / answer type when provided (vqaEval.py per-type tables).
    """

    def __init__(self):
        self.accuracies: list[float] = []
        self.per_question_type = defaultdict(list)
        self.per_answer_type = defaultdict(list)
        self.results: list[dict] = []

    def process(self, question_id, answer: str, gt_answers: list[str],
                question_type: str = None, answer_type: str = None):
        if gt_answers is None:
            # test/test-dev split: no annotations — record the answer for the
            # EvalAI submission dump only (LLaVAVQATESTPipeline.py:29-143)
            self.results.append({"question_id": question_id, "answer": answer})
            return None
        res = normalize_answer(answer)
        gts = [normalize_answer(g) for g in gt_answers]
        accs = []
        for j in range(len(gts)):
            others = gts[:j] + gts[j + 1:]
            matches = sum(1 for o in others if o == res)
            accs.append(min(1.0, matches / 3.0))
        acc = sum(accs) / max(len(accs), 1)
        self.accuracies.append(acc)
        if question_type:
            self.per_question_type[question_type].append(acc)
        if answer_type:
            self.per_answer_type[answer_type].append(acc)
        self.results.append({"question_id": question_id, "answer": answer})
        return acc

    def evaluate(self) -> dict:
        n = max(len(self.accuracies), 1)
        overall = 100.0 * sum(self.accuracies) / n
        return {
            "overall": round(overall, 2),
            "perQuestionType": {k: round(100.0 * sum(v) / len(v), 2)
                                for k, v in self.per_question_type.items()},
            "perAnswerType": {k: round(100.0 * sum(v) / len(v), 2)
                              for k, v in self.per_answer_type.items()},
            "n": len(self.accuracies),
        }

    def dump_results(self, path: str):
        """EvalAI-submission format (cullavo/eval/vqav2/vqa_convert.py)."""
        with open(path, "w") as f:
            json.dump(self.results, f)
