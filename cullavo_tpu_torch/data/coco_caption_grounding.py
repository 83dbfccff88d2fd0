"""The COCO panoptic + caption + grounding data of X-Decoder joint training
(counterpart of ``cullavo_tpu/data/coco_caption_grounding.py``):

  * ``stem`` (the Lancaster / Paice-Husk stemmer, its standard rule table),
    ``text_hash`` (md5 of the stemmed text), ``extract_nouns`` (the
    stopword heuristic: the JAX package's path where no POS tagger data is
    installed) and ``extract_caption_nouns``;
  * ``load_coco_panoptic_caption_grounding_json`` /
    ``register_coco_panoptic_caption_grounding``: panoptic records with
    their captions, grounding annotations and (with an LVIS JSON) LVIS
    instances;
  * ``JointTrainMapper``: a record -> panoptic targets, caption nouns and
    grounding masks / texts / hashes;
  * ``labels_hash_for`` and ``collate_joint``: one static-shape batch, its
    random choices (caption, templates, phrases) drawn from a numpy
    Generator in the JAX package's order, so one seed gives both packages
    the same batch.
"""
from __future__ import annotations

import collections
import hashlib
import json
import re
from typing import Optional, Sequence

import numpy as np

from cullavo_tpu_torch.data.coco_panoptic import (PanopticMapper, load_coco_panoptic_json,
                                                   pad_targets)
from cullavo_tpu_torch.data.datasets import polygons_to_mask, rle_to_mask
from cullavo_tpu_torch.data.registry import register_dataset
from cullavo_tpu_torch.utils.constants import prompt_engineering

_HASH_MOD = 10 ** 16

# the Paice-Husk rules: reversed ending, "*" = only on an intact word, the
# count of letters to remove, the letters to append, ">" = go on stemming,
# "." = stop
_LANCASTER_RULES = (
    "ai*2.", "a*1.", "bb1.", "city3s.", "ci2>", "cn1t>", "dd1.", "dei3y>", "deec2ss.",
    "dee1.", "de2>", "dooh4>", "e1>", "feil1v.", "fi2>", "gni3>", "gai3y.", "ga2>", "gg1.",
    "ht*2.", "hsiug5ct.", "hsi3>", "i*1.", "i1y>", "ji1d.", "juf1s.", "ju1d.", "jo1d.",
    "jeh1r.", "jrev1t.", "jsim2t.", "jn1d.", "j1s.", "lbaifi6.", "lbai4y.", "lba3>", "lbi3.",
    "lib2l>", "lc1.", "lufi4y.", "luf3>", "lu2.", "lai3>", "lau3>", "la2>", "ll1.", "mui3.",
    "mu*2.", "msi3>", "mm1.", "nois4j>", "noix4ct.", "noi3>", "nai3>", "na2>", "nee0.",
    "ne2>", "nn1.", "pihs4>", "pp1.", "re2>", "rae0.", "ra2.", "ro2>", "ru2>", "rr1.", "rt1>",
    "rei3y>", "sei3y>", "sis2.", "si2>", "ssen4>", "ss0.", "suo3>", "su*2.", "s*1>", "s0.",
    "tacilp4y.", "ta2>", "tnem4>", "tne3>", "tna3>", "tpir2b.", "tpro2b.", "tcud1.",
    "tpmus2.", "tpec2iv.", "tulo2v.", "tsis0.", "tsi3>", "tt1.", "uqi3.", "ugo1.", "vis3j>",
    "vie0.", "vi2>", "ylb1>", "yli3y>", "ylp0.", "yl2>", "ygo1.", "yhp1.", "ymo1.", "ypo1.",
    "yti3>", "yte3>", "ytl2.", "yrtsi5.", "yra3>", "yro3>", "yfi3.", "ycn2t>", "yca3>",
    "zi2>", "zy1s.",
)
_RULE = re.compile(r"^([a-z]+)(\*?)(\d)([a-z]*)([>\.]?)$")


def _parse_rules() -> dict:
    table: dict = {}
    for rule in _LANCASTER_RULES:
        ending, intact, remove, append, cont = _RULE.match(rule).groups()
        table.setdefault(rule[0], []).append((ending[::-1], bool(intact), int(remove), append,
                                              cont == "."))
    return table


_RULES = _parse_rules()


def _acceptable(word: str, remove: int) -> bool:
    """A stem keeps 2 letters after a leading vowel, else 3 with a vowel
    among the first three."""
    if word[0] in "aeiouy":
        return len(word) - remove >= 2
    return len(word) - remove >= 3 and (word[1] in "aeiouy" or word[2] in "aeiouy")


def stem(word: str) -> str:
    """The Lancaster stemmer, rule for rule (rules are keyed by the last
    letter of the word's leading run of letters and matched against the
    word's end)."""
    word = word.lower()
    intact = word
    while True:
        last = -1
        for i, ch in enumerate(word):
            if not ch.isalpha():
                break
            last = i
        if last < 0 or word[last] not in _RULES:
            return word
        for ending, intact_only, remove, append, stop in _RULES[word[last]]:
            if not word.endswith(ending) or (intact_only and word != intact):
                continue
            if _acceptable(word, remove):
                word = word[:len(word) - remove] + append
                break
        else:
            return word
        if stop:
            return word


def text_hash(text: str) -> int:
    """Stable noun / caption hash: md5 of the stemmed lower-case text."""
    return int(hashlib.md5(stem(text.lower()).encode()).hexdigest()[:15], 16) % _HASH_MOD


_STOPWORDS = frozenset(
    "a an the this that these those there here is are was were be been being "
    "am do does did have has had having will would shall should may might can "
    "could must of in on at by for with from to into onto over under above "
    "below between through during before after about against along among "
    "around behind beside near off out up down and or but nor so yet as if "
    "while because since until than then when where why how what which who "
    "whom whose it its he she his her him they them their we us our you your "
    "i me my mine not no nor very too also just only quite some any each "
    "every all both few more most other another such own same s t don now "
    "sitting standing looking walking running holding wearing riding playing "
    "eating flying jumping laying hanging parked covered filled topped".split())


def extract_nouns(text: str) -> list:
    """Caption -> candidate nouns: alphabetic words longer than two letters
    that are not function words."""
    words = [w.strip(".,!?;:'\"()") for w in text.lower().split()]
    return [w for w in words if w and w.isalpha() and len(w) > 2 and w not in _STOPWORDS]


def extract_caption_nouns(caption: str, similarity: Optional[dict] = None,
                          threshold: float = 0.95,
                          class_names: Optional[Sequence[str]] = None) -> list:
    """The nouns the caption loss keeps: those whose class similarity is
    below ``threshold`` (``similarity``: {noun: (score, ...)}), or, without
    a table, those whose stem is no class name's."""
    nouns = extract_nouns(caption)
    if similarity is not None:
        return [n for n in nouns if similarity.get(n, (0.0,))[0] < threshold]
    if class_names:
        stemmed = {stem(c.split("-")[0].split(" ")[-1].lower()) for c in class_names}
        return [n for n in nouns if stem(n) not in stemmed]
    return nouns


def _by_image(path: str) -> dict:
    with open(path) as f:
        info = json.load(f)
    out = collections.defaultdict(list)
    for ann in info["annotations"]:
        out[int(ann["image_id"])].append(ann)
    return out


def load_coco_panoptic_caption_grounding_json(panoptic_json: str, image_dir: str,
                                              panoptic_dir: str, caption_json: str,
                                              grounding_json: str, metadata: dict,
                                              lvis_json: Optional[str] = None) -> list:
    """Panoptic records, each with ``captions`` [str], ``grounding_info``
    [COCO-instance-style annotations with sentences] and, with
    ``lvis_json``, ``lvis_info`` [the image's LVIS annotations]."""
    records = load_coco_panoptic_json(panoptic_json, image_dir, panoptic_dir, metadata)
    captions = _by_image(caption_json)
    grounding = _by_image(grounding_json)
    lvis = _by_image(lvis_json) if lvis_json is not None else None
    for rec in records:
        key = int(rec["image_id"])
        rec["captions"] = [a["caption"] for a in captions.get(key, [])]
        rec["grounding_info"] = grounding.get(key, [])
        if lvis is not None:
            rec["lvis_info"] = lvis.get(key, [])
    return records


def register_coco_panoptic_caption_grounding(name: str, panoptic_json: str, image_dir: str,
                                             panoptic_dir: str, caption_json: str,
                                             grounding_json: str,
                                             metadata: Optional[dict] = None,
                                             lvis_json: Optional[str] = None):
    md = dict(metadata or {})
    register_dataset(name, lambda: load_coco_panoptic_caption_grounding_json(
        panoptic_json, image_dir, panoptic_dir, caption_json, grounding_json, md,
        lvis_json=lvis_json), md)


def _nearest_square(m: np.ndarray, S: int) -> np.ndarray:
    H, W = m.shape
    yy = np.clip((np.arange(S) + 0.5) * H / S, 0, H - 1).astype(np.int64)
    xx = np.clip((np.arange(S) + 0.5) * W / S, 0, W - 1).astype(np.int64)
    return m[yy][:, xx]


class JointTrainMapper:
    """Merged record -> ``PanopticMapper``'s output plus ``captions``,
    ``captions_noun`` (per caption), ``grounding_masks`` [S, S] f32 each
    (polygon or uncompressed-RLE segments, nearest-resized),
    ``grounding_texts`` (the lower-cased sentences of each annotation) and
    ``grounding_hash`` (of each one's first sentence); None where the
    panoptic mapper drops the record."""

    def __init__(self, image_size: int = 512, class_names=None,
                 similarity: Optional[dict] = None, caption_thres: float = 0.95,
                 load_image=None):
        self.panoptic = PanopticMapper(image_size=image_size, load_image=load_image)
        self.image_size = image_size
        self.class_names = class_names
        self.similarity = similarity
        self.caption_thres = caption_thres

    def __call__(self, record: dict) -> Optional[dict]:
        out = self.panoptic(record)
        if out is None:
            return None
        captions = list(record.get("captions", []))
        out["captions"] = captions
        out["captions_noun"] = [extract_caption_nouns(c, self.similarity, self.caption_thres,
                                                      self.class_names) for c in captions]
        S = self.image_size
        g_masks, g_texts, g_hash = [], [], []
        for ann in record.get("grounding_info", []):
            seg = ann.get("segmentation")
            if seg is None or not ann.get("sentences"):
                continue
            if isinstance(seg, dict):
                m = rle_to_mask(seg)
            else:
                m = polygons_to_mask(seg, ann.get("height", record.get("height", S)),
                                     ann.get("width", record.get("width", S)))
            g_masks.append(_nearest_square(m, S).astype(np.float32))
            g_texts.append([s["raw"].lower() if isinstance(s, dict) else str(s)
                            for s in ann["sentences"]])
            g_hash.append(text_hash(g_texts[-1][0]))
        out["grounding_masks"] = g_masks
        out["grounding_texts"] = g_texts
        out["grounding_hash"] = g_hash
        return out


def labels_hash_for(classes: np.ndarray, class_names: Sequence[str]) -> np.ndarray:
    """Per-instance hashes of the cleaned class names."""
    cleaned = [c.replace("-other", "").replace("-merged", "").replace("-stuff", "")
               for c in class_names]
    table = np.asarray([text_hash(c) for c in cleaned], np.int64)
    return table[np.clip(classes, 0, len(table) - 1)]


def collate_joint(mapped: list, tokenize, class_names: Sequence[str], rng: np.random.Generator,
                  max_instances: int = 20, max_positives: int = 8, max_groundings: int = 4,
                  mask_size: Optional[int] = None) -> dict:
    """Mapped rows -> one static-shape joint batch: ``pad_targets`` plus
    ``labels_hash`` [B, N]; ``caption_ids`` / ``caption_mask`` [B, P, T]
    (noun prompts, then the sampled caption), ``caption_hash``,
    ``caption_valid`` [B, P]; ``caption_text_ids`` / ``_mask`` [B, T];
    ``grounding_ids`` / ``grounding_token_mask`` [B, G, T],
    ``grounding_hash``, ``grounding_valid`` [B, G] and ``grounding_masks``
    [B, G, ms, ms].  Per image one caption and, per phrase, one sentence are
    drawn from ``rng``."""
    batch = pad_targets(mapped, max_instances, mask_size=mask_size)
    B = len(mapped)
    batch["labels_hash"] = np.where(batch["valid"], labels_hash_for(batch["classes"],
                                                                    class_names),
                                    0).astype(np.int64)
    ms = mask_size or next(m for m in mapped if m is not None)["image"].shape[0]
    T = np.asarray(tokenize(["probe"])[0]).shape[-1]
    P, G = max_positives, max_groundings
    cap_ids = np.zeros((B, P, T), np.int32)
    cap_mask = np.zeros((B, P, T), np.int32)
    cap_hash = np.zeros((B, P), np.int64)
    cap_valid = np.zeros((B, P), bool)
    cap_text_ids = np.zeros((B, T), np.int32)
    cap_text_mask = np.zeros((B, T), np.int32)
    g_ids = np.zeros((B, G, T), np.int32)
    g_mask = np.zeros((B, G, T), np.int32)
    g_hash = np.zeros((B, G), np.int64)
    g_valid = np.zeros((B, G), bool)
    g_masks = np.zeros((B, G, ms, ms), np.float32)
    for i, m in enumerate(mapped):
        if m is None:
            continue
        caps = m.get("captions") or []
        if caps:
            j = int(rng.integers(len(caps)))
            text = caps[j]
            nouns = (m.get("captions_noun") or [[]] * len(caps))[j]
            texts = [prompt_engineering(n, topk=10000, suffix=".", rng=rng)
                     for n in nouns[:P - 1]] + [text]
            ids, msk = tokenize(texts)
            n = len(texts)
            cap_ids[i, :n] = np.asarray(ids)[:, :T]
            cap_mask[i, :n] = np.asarray(msk)[:, :T]
            cap_hash[i, :n] = [text_hash(x) for x in nouns[:P - 1]] + [text_hash(text)]
            cap_valid[i, :n] = True
            tid, tmsk = tokenize([text])
            cap_text_ids[i] = np.asarray(tid).reshape(-1)[:T]
            cap_text_mask[i] = np.asarray(tmsk).reshape(-1)[:T]
        gm = m.get("grounding_masks") or []
        if gm:
            order = rng.permutation(len(gm))[:G]
            texts = [m["grounding_texts"][k][int(rng.integers(len(m["grounding_texts"][k])))]
                     for k in order]
            ids, msk = tokenize(texts)
            n = len(order)
            g_ids[i, :n] = np.asarray(ids)[:, :T]
            g_mask[i, :n] = np.asarray(msk)[:, :T]
            # the hash of the sentence drawn (the one embedded)
            g_hash[i, :n] = [text_hash(t) for t in texts]
            g_valid[i, :n] = True
            for slot, k in enumerate(order):
                src = gm[k]
                g_masks[i, slot] = src if src.shape == (ms, ms) else _nearest_square(src, ms)
    batch.update({"caption_ids": cap_ids, "caption_mask": cap_mask, "caption_hash": cap_hash,
                  "caption_valid": cap_valid, "caption_text_ids": cap_text_ids,
                  "caption_text_mask": cap_text_mask, "grounding_ids": g_ids,
                  "grounding_token_mask": g_mask, "grounding_hash": g_hash,
                  "grounding_valid": g_valid, "grounding_masks": g_masks})
    return batch
