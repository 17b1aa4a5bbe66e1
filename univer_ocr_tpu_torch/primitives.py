"""Alphabet and bit-plane character encoding (a copy of the alphabet part
of univer_ocr_tpu/primitives: the same 162-char ordering, LSB-first
encoding and RU/EN look-alike pairs).  The font registry is left out, so
nothing here needs PIL or system fonts."""

import string
from math import ceil, log

RUSSIAN_LOWERCASE = u'абвгдеёжзийклмнопрстуфхцчшщъыьэюя'
RUSSIAN_UPPERCASE = u'АБВГДЕЁЖЗИЙКЛМНОПРСТУФХЦЧШЩЪЫЬЭЮЯ'
ENGLISH_LOWERCASE = u'abcdefghijklmnopqrstuvwxyz'
ENGLISH_UPPERCASE = u'ABCDEFGHIJKLMNOPQRSTUVWXYZ'
RUSSIAN = RUSSIAN_LOWERCASE + RUSSIAN_UPPERCASE
ENGLISH = ENGLISH_LOWERCASE + ENGLISH_UPPERCASE

#: The 162-character alphabet.  Index order defines both the class id of the
#: Char model's softmax head and the bit-plane encoding below
#: (reference primitives/__init__.py:13-14).
CHARS = '\t' + ' ' + RUSSIAN + string.digits + ENGLISH + string.punctuation
CHARS_IDS = {char: i for i, char in enumerate(CHARS)}

# Visually-similar Cyrillic/Latin glyph pairs (reference :16-42).  Decoded
# text collapses consecutive similar glyphs (see interpreter.PredToText).
SIMILAR_CHARS_PAIRS_LIST = [
    # Lowercase: а/a е/e о/o р/p с/c у/y х/x
    (RUSSIAN_LOWERCASE[0], ENGLISH_LOWERCASE[0]),
    (RUSSIAN_LOWERCASE[5], ENGLISH_LOWERCASE[4]),
    (RUSSIAN_LOWERCASE[15], ENGLISH_LOWERCASE[14]),
    (RUSSIAN_LOWERCASE[17], ENGLISH_LOWERCASE[15]),
    (RUSSIAN_LOWERCASE[18], ENGLISH_LOWERCASE[2]),
    (RUSSIAN_LOWERCASE[20], ENGLISH_LOWERCASE[24]),
    (RUSSIAN_LOWERCASE[22], ENGLISH_LOWERCASE[23]),
    # Uppercase: А/A В/B Е/E К/K М/M О/O Н/H Р/P С/C Т/T Х/X
    (RUSSIAN_UPPERCASE[0], ENGLISH_UPPERCASE[0]),
    (RUSSIAN_UPPERCASE[2], ENGLISH_UPPERCASE[1]),
    (RUSSIAN_UPPERCASE[5], ENGLISH_UPPERCASE[4]),
    (RUSSIAN_UPPERCASE[11], ENGLISH_UPPERCASE[10]),
    (RUSSIAN_UPPERCASE[13], ENGLISH_UPPERCASE[12]),
    (RUSSIAN_UPPERCASE[15], ENGLISH_UPPERCASE[14]),
    (RUSSIAN_UPPERCASE[14], ENGLISH_UPPERCASE[7]),
    (RUSSIAN_UPPERCASE[17], ENGLISH_UPPERCASE[15]),
    (RUSSIAN_UPPERCASE[18], ENGLISH_UPPERCASE[2]),
    (RUSSIAN_UPPERCASE[19], ENGLISH_UPPERCASE[19]),
    (RUSSIAN_UPPERCASE[22], ENGLISH_UPPERCASE[23]),
]
SIMILAR_CHARS = {
    k: v
    for v in SIMILAR_CHARS_PAIRS_LIST
    for k in v
}

#: Number of binary mask layers each character is drawn into (== 8 for the
#: 162-char alphabet; reference primitives/__init__.py:44).
BITS_COUNT = ceil(log(len(CHARS) + 1, 2))

#: char -> LSB-first fixed-width bit string (reference :46-50).
ENCODING_MAP = {
    char: (bin(char_id)[2:][::-1] + '0' * BITS_COUNT)[:BITS_COUNT]
    for char_id, char in enumerate(CHARS)
}
DECODING_MAP = {encoded: char for char, encoded in ENCODING_MAP.items()}


def are_similar(char1, char2):
    """True iff the two glyphs form a registered RU/EN look-alike pair."""
    return char1 in SIMILAR_CHARS.get(char2, ())


def encode_char(char):
    """Char -> bit string; unknown chars map to all-ones (reference :57-59)."""
    assert len(char) == 1
    return ENCODING_MAP.get(char, '1' * BITS_COUNT)


def decode_char(encoded):
    """Bit string -> char, or 'unknown' (reference :62-64)."""
    assert len(encoded) == BITS_COUNT and set(encoded) in [{'0'}, {'1'}, {'0', '1'}]
    return DECODING_MAP.get(encoded, 'unknown')
