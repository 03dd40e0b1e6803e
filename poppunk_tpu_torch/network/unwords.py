"""Host network code, copied from poppunk_tpu/network/unwords.py (that
package loads jax on import); its imports point at this package.

Pronounceable non-word cluster name generator.

Role matches the reference's unwords.py (PopPUNK/unwords.py:8-35): new
clusters get a unique, pronounceable, not-a-real-word name. The reference
checks candidates against a bundled 466k-word English dictionary; we embed a
compact list of common short English words instead (candidates are 2-3
nonsense syllables, so collisions with rarer words are already unlikely).
"""

import random
import string

_COMMON_WORDS = frozenset(
    """aba about after again all also and any are away back ban bag bad bat bed
    been before being best between big body book both but by came can come
    could day did dog down each end even ever every face fact far few find
    first for from get give go good got great had has have he head her here
    him his home house how if in into is it its just know large last left
    life like line little long look made make man many may me men might more
    most mother much must my name never new next no not now of off old on
    once one only or other our out over own part people place put right said
    same saw say see she should side since so some still such take tell than
    that the their them then there these they thing think this those three
    through time to too two under up us use very want was water way we well
    went were what when where which while who why will with word work world
    would year you your baby cake dada gaga lala mama nana papa tata""".split()
)

_VOWELS = ["a", "e", "i", "o", "u"]
_TROUBLE = {"q", "x", "y"}
_CONSONANTS = sorted(set(string.ascii_lowercase) - set(_VOWELS) - _TROUBLE)


def gen_unword(unique=True, rng=None):
    """Generator of pronounceable unique non-words (syllable sampler
    following the reference's construction: v / cv / cvc syllables)."""
    rng = rng or random.Random()
    returned = set()
    vowel = lambda: rng.choice(_VOWELS)
    consonant = lambda: rng.choice(_CONSONANTS)
    syllables = [
        lambda: vowel(),
        lambda: consonant() + vowel(),
        lambda: consonant() + vowel() + consonant(),
    ]
    while True:
        while True:
            word = "".join(rng.choice(syllables)() for _ in range(rng.randint(2, 3)))
            if word not in _COMMON_WORDS and (not unique or word not in returned):
                returned.add(word)
                break
        yield word
