"""English singularization for GQA token normalisation — pattern-exact.

The PyTorch port's own copy of ``dfol_vqa_tpu/compiler/normalize.py``, which it must not import
(the port imports nothing of the JAX package); it behaves exactly as
that module, and tests/test_torch_host.py holds the two equal.

The reference normalizes every token through ``pattern.text.en.singularize``
wrapped in exception lists (src/nsvqa/nn/parser/parse_utils.py:9-20). The
``pattern`` library is a fixed, ordered regex-rule cascade (CLiPS
pattern/text/en/inflect.py, BSD); this module transcribes that cascade so
token codes match the reference bit-for-bit WITHOUT the (unpackagable)
dependency — including pattern's deliberate warts, which the GQA vocabulary
itself fingerprints: ``gqa_vocab.json`` contains ``tenni``, ``cactu``,
``octopu``, ``deliciou``, ``curiou`` — i.e. the dataset's canonical codes
were produced by pattern's terminal ``([^s])s$`` strip, so a "more correct"
singularizer would assign DIFFERENT codes than the reference
(tests/test_singularize.py pins these fingerprints).
"""

from __future__ import annotations

import re

# parse_utils.py:10-12 (data lists, kept verbatim for behavioural parity)
PLURALE_TANTUM = {
    "this", "yes", "pants", "shorts", "glasses", "scissors", "panties", "trousers",
    "binoculars", "pliers", "tongs", "tweezers", "forceps", "goggles", "jeans",
    "tights", "leggings", "chaps", "boxers", "indoors", "outdoors", "bus", "octapus",
    "waitress", "pasta", "pita", "glass", "asparagus", "hummus", "dress", "cafeteria",
    "grass", "class",
}

# parse_utils.py:14
IRREGULARS = {
    "shelves": "shelf",
    "bookshelves": "bookshelf",
    "olives": "olive",
    "brownies": "brownie",
    "cookies": "cookie",
}

# ---------------------------------------------------------------------------
# pattern.text.en.inflect singularization (transcribed rule cascade)
# ---------------------------------------------------------------------------

_SINGULAR_RULES = [
    (re.compile(s), r)
    for s, r in [
        (r"(?i)(.)ae$", "\\1a"),
        (r"(?i)(.)itis$", "\\1itis"),
        (r"(?i)(.)eaux$", "\\1eau"),
        (r"(?i)(quiz)zes$", "\\1"),
        (r"(?i)(matr)ices$", "\\1ix"),
        (r"(?i)(ap|vert|ind)ices$", "\\1ex"),
        (r"(?i)^(ox)en", "\\1"),
        (r"(?i)(alias|status)es$", "\\1"),
        # NB: [octop|vir] is a character class in the original — kept as-is
        (r"(?i)([octop|vir])i$", "\\1us"),
        (r"(?i)(cris|ax|test)es$", "\\1is"),
        (r"(?i)(shoe)s$", "\\1"),
        (r"(?i)(o)es$", "\\1"),
        (r"(?i)(bus)es$", "\\1"),
        (r"(?i)([m|l])ice$", "\\1ouse"),
        (r"(?i)(x|ch|ss|sh)es$", "\\1"),
        (r"(?i)(m)ovies$", "\\1ovie"),
        (r"(?i)(.)ombies$", "\\1ombie"),
        (r"(?i)(s)eries$", "\\1eries"),
        (r"(?i)([^aeiouy]|qu)ies$", "\\1y"),
        # certain words ending in -f or -fe take -ves in the plural
        (r"(?i)([aeo]l)ves$", "\\1f"),
        (r"(?i)([^d]ea)ves$", "\\1f"),
        (r"(?i)(ar)ves$", "\\1f"),
        (r"(?i)([nlw]i)ves$", "\\1fe"),
        (r"(?i)([lr])ves$", "\\1f"),
        (r"(?i)([aeo])ves$", "\\1ve"),
        (r"(?i)(sive)s$", "\\1"),
        (r"(?i)(tive)s$", "\\1"),
        (r"(?i)(hive)s$", "\\1"),
        (r"(?i)([^f])ves$", "\\1fe"),
        (r"(?i)(^analy)ses$", "\\1sis"),
        (r"(?i)((a)naly|(b)a|(d)iagno|(p)arenthe|(p)rogno|(s)ynop|(t)he)ses$", "\\1\\2sis"),
        (r"(?i)(.)opses$", "\\1opsis"),
        (r"(?i)(.)yses$", "\\1ysis"),
        (r"(?i)(h|d|r|o|n|b|cl|p)oses$", "\\1ose"),
        (r"(?i)(fruct|gluc|galact|lact|ket|malt|rib|sacchar|cellul)ose$", "\\1ose"),
        (r"(?i)(.)oses$", "\\1osis"),
        (r"(?i)([ti])a$", "\\1um"),
        (r"(?i)(n)ews$", "\\1ews"),
        (r"(?i)([^s])s$", "\\1"),
    ]
]

_SINGULAR_UNINFLECTED = [
    "bison", "debris", "headquarters", "pincers", "trout", "aircraft", "bellows",
    "bream", "breeches", "britches", "carp", "chassis", "clippers", "cod",
    "contretemps", "corps", "diabetes", "djinn", "eland", "elk", "gallows",
    "graffiti", "herpes", "high-jinks", "homework", "innings", "jackanapes",
    "mackerel", "measles", "mews", "mumps", "news", "pliers", "proceedings",
    "rabies", "salmon", "scissors", "sea-bass", "series", "shears", "species",
    "swine", "swiss", "tuna", "whiting", "wildebeest",
]

_SINGULAR_UNCOUNTABLE = [
    "advice", "bread", "butter", "cannabis", "cheese", "electricity", "equipment",
    "fruit", "furniture", "garbage", "gravel", "happiness", "information",
    "ketchup", "knowledge", "love", "luggage", "mathematics", "mayonnaise",
    "meat", "mustard", "news", "progress", "research", "rice", "sand",
    "software", "understanding", "water",
]

_SINGULAR_IE = [
    "alergie", "cutie", "hoagie", "newbie", "softie", "veggie", "auntie",
    "budgie", "caddie", "cookie", "collie", "doggie", "eyrie", "freebie",
    "goonie", "groupie", "hankie", "hippie", "hoodie", "indie", "junkie",
    "laddie", "laramie", "lingerie", "meanie", "nightie", "oldie", "^pie",
    "pixie", "quickie", "reverie", "rookie", "smoothie", "techie", "^tie",
    "toughie", "valkyrie", "veggie", "weenie", "yuppie", "zombie",
]

_SINGULAR_IRREGULAR = {
    "atlantes": "atlas",
    "atlases": "atlas",
    "axes": "axe",
    "beeves": "beef",
    "brethren": "brother",
    "children": "child",
    "corpora": "corpus",
    "corpuses": "corpus",
    "ephemerides": "ephemeris",
    "feet": "foot",
    "ganglia": "ganglion",
    "geese": "goose",
    "genii": "genie",
    "men": "man",
    "mongooses": "mongoose",
    "monies": "money",
    "moves": "move",
    "mythoi": "mythos",
    "numena": "numen",
    "occipita": "occiput",
    "octopodes": "octopus",
    "opera": "opus",
    "opuses": "opus",
    "our": "my",
    "oxen": "ox",
    "penes": "penis",
    "penises": "penis",
    "people": "person",
    "sexes": "sex",
    "soliloquies": "soliloquy",
    "teeth": "tooth",
    "testes": "testis",
    "trilbys": "trilby",
    "turves": "turf",
    "zoa": "zoon",
}

_PLURAL_PREPOSITIONS = {
    "about", "before", "during", "of", "till", "above", "behind", "except",
    "off", "to", "across", "below", "for", "on", "under", "after", "beneath",
    "from", "onto", "until", "among", "beside", "in", "out", "unto", "around",
    "besides", "into", "over", "upon", "at", "between", "near", "since",
    "with", "athwart", "betwixt", "of", "than", "beyond", "but", "by",
}


def singularize_word(word: str) -> str:
    """pattern.text.en.singularize(word, pos=NOUN) transcription."""
    w = word
    if "-" in w:
        parts = w.split("-")
        if len(parts) > 1 and parts[1] in _PLURAL_PREPOSITIONS:
            # mothers-in-law -> mother-in-law
            return singularize_word(parts[0]) + "-" + "-".join(parts[1:])
    # dogs' => dog's
    if w.endswith("'"):
        return singularize_word(w[:-1]) + "'s"
    lw = w.lower()
    for x in _SINGULAR_UNINFLECTED:
        if x.endswith(lw):
            return w
    for x in _SINGULAR_UNCOUNTABLE:
        if x.endswith(lw):
            return w
    for x in _SINGULAR_IE:
        if lw.endswith(x.lstrip("^") + "s") and (
            not x.startswith("^") or lw == x[1:] + "s"
        ):
            return w[:-1]
    for x, repl in _SINGULAR_IRREGULAR.items():
        if lw.endswith(x):
            return re.sub("(?i)" + x + "$", repl, w)
    for suffix, inflection in _SINGULAR_RULES:
        m = suffix.search(w)
        if m:
            groups = m.groups()
            for k in range(len(groups)):
                if groups[k] is None:
                    inflection = inflection.replace("\\" + str(k + 1), "")
            return suffix.sub(inflection, w)
    return w


def normalize(string: str) -> str:
    """parse_utils.py:9-20: lowercase/strip, exception lists, then
    pattern-singularize the whole phrase (the rule cascade anchors at the
    string end, so it effectively inflects the final word)."""
    temp = string.strip().lower()
    if temp in IRREGULARS:
        return IRREGULARS[temp]
    if temp.split(" ")[-1] in PLURALE_TANTUM or temp[-2:] == "ss":
        return temp
    return singularize_word(temp)
