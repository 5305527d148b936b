"""NLP nodes (reference ``nodes/nlp``).

Counterpart of ``keystone_tpu/nodes/nlp``, with the same exported names.
Text processing is host-stage work (ragged, non-numeric); featurization
hands off to the device through sparse vectors (``nodes/util/sparse``).
The CoreNLP- and Epic-backed nodes of the reference (CoreNLPFeatureExtractor,
POSTagger, NER) keep their node surface with pluggable models; trained
averaged perceptrons, shipped in ``data/``, are the defaults
(``corenlp.py``).
"""
from .corenlp import (
    CoreNLPFeatureExtractor,
    NER,
    POSTagger,
    RuleBasedNerModel,
    RuleBasedPosModel,
    Segmentation,
    TaggedSequence,
    english_lemmatize,
)
from .hashing import HashingTF, NGramsHashingTF, java_string_hash, scala_hash
from .indexers import NaiveBitPackIndexer, NGramIndexer, NGramIndexerImpl
from .ngrams import (
    DEFAULT_MODE,
    NO_ADD_MODE,
    NGram,
    NGramsCounts,
    NGramsFeaturizer,
)
from .stupid_backoff import StupidBackoffEstimator, StupidBackoffModel
from .text import LowerCase, Tokenizer, Trim
from .word_freq import OOV_INDEX, WordFrequencyEncoder, WordFrequencyTransformer

__all__ = [
    "CoreNLPFeatureExtractor",
    "NER",
    "POSTagger",
    "RuleBasedNerModel",
    "RuleBasedPosModel",
    "Segmentation",
    "TaggedSequence",
    "english_lemmatize",
    "HashingTF",
    "NGramsHashingTF",
    "java_string_hash",
    "scala_hash",
    "NaiveBitPackIndexer",
    "NGramIndexer",
    "NGramIndexerImpl",
    "NGram",
    "NGramsCounts",
    "NGramsFeaturizer",
    "DEFAULT_MODE",
    "NO_ADD_MODE",
    "StupidBackoffEstimator",
    "StupidBackoffModel",
    "LowerCase",
    "Tokenizer",
    "Trim",
    "WordFrequencyEncoder",
    "WordFrequencyTransformer",
    "OOV_INDEX",
]
