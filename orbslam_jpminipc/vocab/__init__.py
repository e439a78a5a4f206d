"""Place-recognition vocabulary: dense binary-descriptor scoring.

Replaces the DBoW2 stack (Thirdparty/DBoW2: TemplatedVocabulary's k-ary
tree descent, BowVector/FeatureVector sparse maps, ScoringObject L1
scoring). The tree exists only to prune CPU work, so the vocabulary
is FLAT: every descriptor is assigned its exact nearest word by one int8
matmul (better recall than DBoW2's greedy descent), and BoW vectors
are dense tf-idf arrays scored with the same L1 metric (Nister 2006,
ScoringObject.cpp:30-68).
"""
from .vocabulary import Vocabulary, build_vocabulary  # noqa: F401
