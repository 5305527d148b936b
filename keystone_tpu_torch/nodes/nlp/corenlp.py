"""Linguistic annotation nodes (reference ``nodes/nlp/CoreNLPFeatureExtractor
.scala:18-38``, ``POSTagger.scala:24-35``, ``NER.scala:20-31``).

Counterpart of ``keystone_tpu/nodes/nlp/corenlp.py``. The reference wraps
JVM model libraries (CoreNLP through sista-processors, Epic's CRF and
SemiCRF). The node surface is kept: a pluggable model object with
``best_sequence(words)``. The defaults are the trained averaged
perceptrons of ``perceptron_pos.py`` and ``perceptron_ner.py``, whose
weights this package ships in ``data/``, and the rule-based English
models below where those weights are absent.

These are host stages: tagging and lemmatizing are ragged string work.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from ...workflow.operators import data_token
from ...workflow.transformer import HostTransformer

# --------------------------------------------------------------- lemmatizer

#: Irregular English forms (closed list, the usual suspects).
_IRREGULAR = {
    "was": "be", "were": "be", "is": "be", "are": "be", "am": "be",
    "been": "be", "being": "be", "'s": "be", "'re": "be", "'m": "be",
    "has": "have", "had": "have", "having": "have", "'ve": "have",
    "does": "do", "did": "do", "done": "do", "doing": "do",
    "goes": "go", "went": "go", "gone": "go", "going": "go",
    "said": "say", "says": "say", "made": "make", "took": "take",
    "taken": "take", "came": "come", "saw": "see", "seen": "see",
    "knew": "know", "known": "know", "got": "get", "gotten": "get",
    "gave": "give", "given": "give", "found": "find", "thought": "think",
    "told": "tell", "became": "become", "left": "leave", "felt": "feel",
    "kept": "keep", "held": "hold", "brought": "bring", "bought": "buy",
    "wrote": "write", "written": "write", "ran": "run", "spoke": "speak",
    "spoken": "speak", "stood": "stand", "lost": "lose", "paid": "pay",
    "met": "meet", "sat": "sit", "led": "lead", "grew": "grow",
    "grown": "grow", "meant": "mean", "sent": "send", "built": "build",
    "spent": "spend", "fell": "fall", "fallen": "fall", "drew": "draw",
    "drawn": "draw", "broke": "break", "broken": "break", "wore": "wear",
    "worn": "wear", "chose": "choose", "chosen": "choose",
    "children": "child", "men": "man", "women": "woman",
    "people": "person", "mice": "mouse", "feet": "foot", "teeth": "tooth",
    "geese": "goose", "lives": "life", "wives": "wife", "knives": "knife",
    "leaves": "leaf", "selves": "self", "better": "good", "best": "good",
    "worse": "bad", "worst": "bad", "further": "far", "furthest": "far",
}

_VOWELS = set("aeiou")
_DOUBLE_OK = set("bdgklmnprt")  # consonants that double before -ing/-ed


def _undouble(stem: str) -> str:
    if (
        len(stem) >= 3
        and stem[-1] == stem[-2]
        and stem[-1] in _DOUBLE_OK
    ):
        return stem[:-1]
    return stem


def _needs_e(stem: str) -> bool:
    """mak+e, writ+e: single-syllable stem ending consonant-vowel-consonant
    (not w/x/y) — the Porter-style restore-e condition. Multi-syllable
    stems (visit+ed) keep no e."""
    if len(stem) < 3:
        return False
    a, b, c = stem[-3], stem[-2], stem[-1]
    if not (
        a not in _VOWELS
        and b in _VOWELS
        and c not in _VOWELS
        and c not in "wxy"
    ):
        return False
    vowel_groups = len(re.findall(r"[aeiou]+", stem))
    return vowel_groups == 1


def english_lemmatize(word: str, pos: Optional[str] = None) -> str:
    """Rule-based English lemmatizer: irregular table + suffix stripping
    with undoubling and CVC e-restoration. ``pos`` (a Penn-style tag)
    restricts -er/-est stripping to adjectives/adverbs."""
    w = word.lower()
    if w in _IRREGULAR:
        return _IRREGULAR[w]
    n = len(w)
    if n > 4 and w.endswith("ies"):
        return w[:-3] + "y"
    if n > 4 and w.endswith(("ches", "shes", "sses", "xes", "zes")):
        return w[:-2]
    if n > 3 and w.endswith("s") and not w.endswith(("ss", "us", "is")):
        return w[:-1]
    # -ing stripping is gerund-only: a POS tag gates it exactly; absent
    # a tag, the -ing-noun exception list (morning, thing, ...) stands in
    ing_ok = (pos == "VBG") if pos is not None else (
        w not in _ING_EXCEPTIONS)  # defined with the tagger below
    if n > 5 and w.endswith("ying") and ing_ok:
        return w[:-4] + "y"
    if n > 4 and w.endswith("ing") and ing_ok:
        stem = _undouble(w[:-3])
        # a doubled consonant implies the base had no final e (run+ning)
        return stem + "e" if stem == w[:-3] and _needs_e(stem) else stem
    if n > 4 and w.endswith("ied"):
        return w[:-3] + "y"
    if n > 3 and w.endswith("ed"):
        stem = _undouble(w[:-2])
        if stem.endswith("e"):
            return stem
        return stem + "e" if stem == w[:-2] and _needs_e(stem) else stem
    if pos in ("JJR", "JJS", "RBR", "RBS"):
        if n > 4 and w.endswith("est"):
            return _undouble(w[:-3])
        if n > 3 and w.endswith("er"):
            return _undouble(w[:-2])
    return w


# --------------------------------------------------------------- POS tagger


@dataclass
class TaggedSequence:
    """Words + per-word tags (the Epic ``TaggedSequence`` analogue)."""

    words: List[str]
    tags: List[str]

    def pairs(self) -> List[Tuple[str, str]]:
        return list(zip(self.words, self.tags))


_CLOSED_CLASS = {
    "the": "DT", "a": "DT", "an": "DT", "this": "DT", "that": "DT",
    "these": "DT", "those": "DT", "some": "DT", "any": "DT", "no": "DT",
    "each": "DT", "every": "DT",
    "of": "IN", "in": "IN", "on": "IN", "at": "IN", "by": "IN",
    "for": "IN", "with": "IN", "from": "IN", "to": "TO", "into": "IN",
    "over": "IN", "under": "IN", "about": "IN", "after": "IN",
    "before": "IN", "between": "IN", "through": "IN", "during": "IN",
    "against": "IN", "as": "IN",
    "i": "PRP", "you": "PRP", "he": "PRP", "she": "PRP", "it": "PRP",
    "we": "PRP", "they": "PRP", "me": "PRP", "him": "PRP", "her": "PRP",
    "us": "PRP", "them": "PRP",
    "my": "PRP$", "your": "PRP$", "his": "PRP$", "its": "PRP$",
    "our": "PRP$", "their": "PRP$",
    "and": "CC", "or": "CC", "but": "CC", "nor": "CC", "yet": "CC",
    "not": "RB", "n't": "RB", "very": "RB", "too": "RB", "also": "RB",
    "will": "MD", "would": "MD", "can": "MD", "could": "MD", "may": "MD",
    "might": "MD", "shall": "MD", "should": "MD", "must": "MD",
    "is": "VBZ", "are": "VBP", "was": "VBD", "were": "VBD", "am": "VBP",
    "be": "VB", "been": "VBN", "being": "VBG",
    "has": "VBZ", "have": "VBP", "had": "VBD",
    "do": "VBP", "does": "VBZ", "did": "VBD",
    "who": "WP", "what": "WP", "which": "WDT", "where": "WRB",
    "when": "WRB", "why": "WRB", "how": "WRB",
    "there": "EX", "if": "IN", "because": "IN", "while": "IN",
    "than": "IN", "without": "IN", "outside": "IN", "inside": "IN",
    "near": "IN", "across": "IN",
    "then": "RB", "now": "RB", "here": "RB", "just": "RB", "only": "RB",
    "never": "RB", "always": "RB", "often": "RB", "still": "RB",
    "already": "RB", "again": "RB", "soon": "RB",
    "all": "DT", "both": "DT",
    "many": "JJ", "few": "JJ", "several": "JJ", "such": "JJ",
    "other": "JJ", "same": "JJ", "own": "JJ",
}

#: Penn punctuation tags; anything non-alphanumeric not listed is SYM.
_PUNCT_TAGS = {
    ".": ".", "!": ".", "?": ".", ",": ",", ";": ":", ":": ":",
    "--": ":", "-": ":", "(": "(", ")": ")", "``": "``", "''": "''",
    '"': "''", "'": "''", "$": "$", "&": "CC",
}

_NUMBER_RE = re.compile(r"^[+-]?(\d+([.,]\d+)*|\d+(st|nd|rd|th))$")

_ADJ_SUFFIXES = ("ous", "ful", "ive", "able", "ible", "al", "ic", "less")
_NOUN_SUFFIXES = ("tion", "sion", "ment", "ness", "ity", "ship", "hood",
                  "ism", "ist", "ance", "ence", "ure", "age")
#: -ing nouns / non-gerunds (so VBG never fires on them).
_ING_EXCEPTIONS = {
    "morning", "evening", "nothing", "something", "anything",
    "everything", "thing", "king", "ring", "spring", "string", "wing",
    "sing", "bring",
}
#: -en words that are NOT past participles (so VBN never fires).
_EN_EXCEPTIONS = {
    "garden", "kitchen", "chicken", "golden", "wooden", "open", "even",
    "seven", "eleven", "heaven", "oven", "often", "queen", "green",
    "screen", "between", "men", "women", "children", "citizen", "dozen",
    "pen", "ten", "then", "when",
}
#: -er words that are NOT comparatives (so JJR never fires on them).
_ER_EXCEPTIONS = {
    "other", "another", "over", "under", "after", "never", "ever",
    "together", "whether", "either", "neither", "however", "rather",
    "water", "corner", "number", "paper", "member", "letter", "center",
    "matter", "order", "power", "summer", "winter", "computer", "user",
    "server", "offer", "answer", "player", "teacher", "writer", "reader",
    "leader", "worker", "manager", "father", "mother", "brother",
    "sister", "daughter", "per", "her",
}


class RuleBasedPosModel:
    """Greedy lexicon + suffix + shape tagger (Penn-style tags): the
    in-tree default model for :class:`POSTagger`. Same one-method
    protocol as the reference's Epic CRF (``model.bestSequence``)."""

    def best_sequence(self, words: Sequence[str]) -> TaggedSequence:
        tags = []
        for i, word in enumerate(words):
            tags.append(self._tag(word, sentence_initial=(i == 0)))
        return TaggedSequence(list(words), tags)

    def _tag(self, word: str, sentence_initial: bool) -> str:
        w = word.lower()
        if not any(c.isalnum() for c in word):
            return _PUNCT_TAGS.get(word, "SYM")
        if _NUMBER_RE.match(word):
            return "CD"
        if w in _CLOSED_CLASS:
            return _CLOSED_CLASS[w]
        if word[:1].isupper() and not sentence_initial:
            plural = (
                len(w) > 4
                and w.endswith("s")
                and not w.endswith(("ss", "us", "is"))
            )
            return "NNPS" if plural else "NNP"
        if w.endswith("ly"):
            return "RB"
        if w.endswith("ing") and len(w) > 4 and w not in _ING_EXCEPTIONS:
            return "VBG"
        if w.endswith("ed") and len(w) > 3:
            return "VBD"
        if w.endswith("en") and len(w) > 3 and w not in _EN_EXCEPTIONS:
            return "VBN"
        if w.endswith(_ADJ_SUFFIXES):
            return "JJ"
        if w.endswith("est") and len(w) > 4:
            return "JJS"
        if (
            w.endswith("er")
            and len(w) > 4
            and w not in _ER_EXCEPTIONS
            and not w.endswith(("ier", "eer"))
        ):
            # likely comparative (faster, bigger); -ier handled via JJ/NN
            return "JJR"
        if w.endswith(_NOUN_SUFFIXES):
            return "NN"
        if w.endswith("s") and not w.endswith(("ss", "us", "is")) and len(w) > 3:
            return "NNS"
        return "NN"


class POSTagger(HostTransformer):
    """words -> :class:`TaggedSequence` (reference ``POSTagger.scala:24-35``,
    which wraps an Epic CRF the same way; any object with
    ``best_sequence(words)`` plugs in).

    Default model: the in-tree TRAINED averaged perceptron
    (``perceptron_pos.py``, shipped-artifact held-out 0.9764 token
    accuracy vs the rule-based stand-in's 0.8392) when its shipped
    weights are present; the rule-based model otherwise."""

    def __init__(self, model=None):
        if model is None:
            from .perceptron_pos import load_pretrained

            model = load_pretrained() or RuleBasedPosModel()
        self.model = model

    def apply(self, words: Sequence[str]) -> TaggedSequence:
        return self.model.best_sequence(list(words))


# --------------------------------------------------------------------- NER


@dataclass
class Segmentation:
    """Labeled spans over a word sequence (the Epic ``Segmentation``
    analogue). ``labels[i]`` is the per-token BIO-collapsed label ('O'
    outside any span)."""

    words: List[str]
    spans: List[Tuple[str, int, int]] = field(default_factory=list)

    @property
    def labels(self) -> List[str]:
        out = ["O"] * len(self.words)
        for label, start, end in self.spans:
            for i in range(start, end):
                out[i] = label
        return out


_HONORIFICS = {"mr", "mrs", "ms", "dr", "prof", "sir", "president",
               "senator", "judge", "captain"}
_ORG_SUFFIXES = {"inc", "corp", "ltd", "llc", "co", "company", "university",
                 "institute", "college", "department", "committee", "group",
                 "association", "agency", "bank", "press"}
_LOCATIONS = {
    "america", "europe", "asia", "africa", "australia", "antarctica",
    "usa", "uk", "france", "germany", "china", "japan", "india", "russia",
    "canada", "mexico", "brazil", "italy", "spain", "england", "scotland",
    "london", "paris", "berlin", "tokyo", "beijing", "moscow", "york",
    "boston", "chicago", "seattle", "texas", "california", "washington",
    "berkeley", "stanford",
}
_FIRST_NAMES = {
    "john", "james", "mary", "robert", "michael", "william", "david",
    "richard", "joseph", "thomas", "charles", "sarah", "karen", "nancy",
    "lisa", "betty", "margaret", "sandra", "ashley", "emily", "anna",
    "alice", "bob", "carol", "dave", "eve", "frank", "grace", "henry",
    "jane", "peter", "paul", "george", "susan", "linda", "barbara",
}


class RuleBasedNerModel:
    """Capitalized-span chunker with gazetteer/affix classification:
    PERSON / LOCATION / ORGANIZATION / NUMBER / MISC. The in-tree default
    for :class:`NER`; same protocol as the reference's Epic SemiCRF."""

    def best_sequence(self, words: Sequence[str]) -> Segmentation:
        words = list(words)
        spans: List[Tuple[str, int, int]] = []
        i = 0
        while i < len(words):
            word = words[i]
            if _NUMBER_RE.match(word):
                spans.append(("NUMBER", i, i + 1))
                i += 1
                continue
            if self._capitalized(word) and (i > 0 or self._known(word)):
                j = i
                while j < len(words) and self._capitalized(words[j]):
                    j += 1
                spans.append((self._classify(words[i:j]), i, j))
                i = j
                continue
            i += 1
        return Segmentation(words, spans)

    @staticmethod
    def _capitalized(word: str) -> bool:
        return bool(word) and word[0].isupper() and any(c.isalpha() for c in word)

    @staticmethod
    def _known(word: str) -> bool:
        w = word.lower().rstrip(".")
        return (
            w in _LOCATIONS or w in _FIRST_NAMES or w in _HONORIFICS
            or w in _ORG_SUFFIXES
        )

    @staticmethod
    def _classify(span_words: List[str]) -> str:
        lows = [w.lower().rstrip(".") for w in span_words]
        if lows[-1] in _ORG_SUFFIXES or any(w in _ORG_SUFFIXES for w in lows):
            return "ORGANIZATION"
        if any(w in _LOCATIONS for w in lows):
            return "LOCATION"
        if lows[0] in _HONORIFICS or any(w in _FIRST_NAMES for w in lows):
            return "PERSON"
        return "MISC"


class NER(HostTransformer):
    """words -> :class:`Segmentation` (reference ``NER.scala:20-31``,
    which wraps an Epic SemiCRF the same way; any object with
    ``best_sequence(words)`` plugs in).

    Default model: the in-tree TRAINED averaged perceptron
    (``perceptron_ner.py``, shipped-artifact held-out token F1 1.000 vs
    the rule-based stand-in's 0.9508) when its shipped weights are
    present; the rule-based model otherwise."""

    def __init__(self, model=None):
        if model is None:
            from .perceptron_ner import load_pretrained

            model = load_pretrained() or RuleBasedNerModel()
        self.model = model

    def apply(self, words: Sequence[str]) -> Segmentation:
        return self.model.best_sequence(list(words))


# -------------------------------------------- CoreNLP feature extraction

_SENTENCE_RE = re.compile(r"(?<=[.!?])\s+")
_TOKEN_RE = re.compile(r"[A-Za-z0-9']+|[^\sA-Za-z0-9]")
#: The reference's normalize pattern verbatim ("[^a-zA-Z0-9\\s+]",
#: CoreNLPFeatureExtractor.scala:36): '+' sits INSIDE the negated class
#: there too, so '+' characters survive normalization ("C++" keeps its
#: plusses). Kept bit-for-bit for feature-space parity.
_NORMALIZE_RE = re.compile(r"[^a-zA-Z0-9\s+]")


def _model_key(model):
    """Equality key for a pluggable model: the stateless rule-based
    models compare by type (so identical pipelines merge in common
    subexpression elimination); any other model by a token of the
    object (``data_token``), so differently configured models never
    merge. The JAX package keys those by ``id()``, which a freed model
    can hand on to a new one (ROADMAP C1)."""
    if type(model) in (RuleBasedPosModel, RuleBasedNerModel):
        return type(model)
    return data_token(model)


class CoreNLPFeatureExtractor(HostTransformer):
    """string -> lemmatized/entity-typed n-grams (reference
    ``CoreNLPFeatureExtractor.scala:18-38``), in order: tokenize into
    sentences, POS-tag, lemmatize, recognize named entities, replace
    entity tokens with their type ("Paris" -> "LOCATION"), normalize
    (strip non-alphanumerics, lowercase), emit n-grams per sentence for
    each requested order (sentence boundaries are respected, as in the
    reference)."""

    def __init__(self, orders: Sequence[int], pos_model=None, ner_model=None):
        self.orders = list(orders)
        if pos_model is None:
            from .perceptron_pos import load_pretrained as _pos

            pos_model = _pos() or RuleBasedPosModel()
        if ner_model is None:
            from .perceptron_ner import load_pretrained as _ner

            ner_model = _ner() or RuleBasedNerModel()
        self.pos_model = pos_model
        self.ner_model = ner_model

    def eq_key(self):
        return (CoreNLPFeatureExtractor, tuple(self.orders),
                _model_key(self.pos_model), _model_key(self.ner_model))

    def apply(self, text: str) -> List[str]:
        sentences = [
            s for s in _SENTENCE_RE.split(text.strip()) if s
        ]
        token_rows: List[List[str]] = []
        for sent in sentences:
            words = _TOKEN_RE.findall(sent)
            if not words:
                continue
            tagged = self.pos_model.best_sequence(words)
            entities = self.ner_model.best_sequence(words).labels
            if len(tagged.tags) != len(words) or len(entities) != len(words):
                raise ValueError(
                    f"model returned {len(tagged.tags)} tags / "
                    f"{len(entities)} entity labels for {len(words)} words"
                )
            row = []
            for word, tag, entity in zip(words, tagged.tags, entities):
                if entity != "O":
                    row.append(entity)
                else:
                    lemma = english_lemmatize(word, tag)
                    row.append(_NORMALIZE_RE.sub("", lemma).lower())
            token_rows.append([t for t in row if t])
        out: List[str] = []
        for n in self.orders:
            for row in token_rows:
                out.extend(
                    " ".join(row[i : i + n])
                    for i in range(len(row) - n + 1)
                )
        return out
