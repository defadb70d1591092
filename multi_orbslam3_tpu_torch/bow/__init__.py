"""Bag-of-words place recognition: the flattened vocabulary tree and the
sparse keyframe database."""
