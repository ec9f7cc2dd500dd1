"""CoreNLP-equivalent featurizer — rule-based, dependency-free
(counterpart of keystone_tpu/ops/corenlp.py, whose rules and tables are
copied here verbatim; reference
src/main/scala/nodes/nlp/CoreNLPFeatureExtractor.scala:18-45).

The reference delegates to the sista FastNLPProcessor (an external CoreNLP
wrapper jar) to tokenize, lemmatize, tag named entities, and emit n-grams
respecting sentence boundaries; tokens that are part of an entity are
replaced by their entity type, everything else by its normalized lemma.

This environment has no CoreNLP models, so the same contract is implemented
host-side with deterministic rules:

* sentence splitting on terminal punctuation;
* an English suffix lemmatizer (irregular table + -ies/-ied/-oes/-es/-s,
  -ing, -ed with consonant-doubling and silent-e restoration), with
  Porter-style vowel-measure guards on every strip so the rules stay safe
  on open vocabulary — covers the reference suite's cases
  (jumping->jump, snakes->snake, hunted->hunt, ...);
* gazetteer + shape NER: PERSON (common given names), LOCATION (countries,
  US states, major cities), ORGANIZATION (Corp/Inc/University ... suffix
  patterns), NUMBER for numeric tokens — matching the entity-type tokens
  the reference emits (PERSON/LOCATION/ORGANIZATION per CoreNLP's tag set);
* n-grams of the requested orders within each sentence, space-joined.

Like the reference (a host-side JVM/NLP step, not a compute kernel), this
runs on the host and touches no device.
"""

from __future__ import annotations

import re
from typing import Sequence

from ..core.pipeline import Transformer

# Terminal punctuation only at a whitespace/end boundary — "3.14" is one
# token, not a sentence break.
_SENT_SPLIT = re.compile(r"[.!?]+(?=\s|$)")
# Numbers keep internal , and . only between digits ("4,200", "3.14" — but
# "2026,Google" is two tokens); word tokens start with a letter (a bare "'''"
# must not become an empty token after normalization).  Digit-led
# alphanumerics ("3d", "90s", "4k") stay ONE token — neither split ("3","d")
# nor tagged NUMBER.
_TOKEN = re.compile(
    r"[0-9](?:[0-9]|[.,](?=[0-9]))*(?:[A-Za-z][A-Za-z0-9']*)?|[A-Za-z][A-Za-z0-9']*"
)
_NON_ALNUM = re.compile(r"[^a-zA-Z0-9\s+]")
_NUMERIC = re.compile(r"^[0-9][0-9,.]*$")

_VOWELS = set("aeiou")

# Irregular lemmas (the high-frequency closed class; suffix rules handle the
# regular inflections).
_IRREGULAR = {
    "ran": "run", "ate": "eat", "went": "go", "gone": "go", "saw": "see",
    "seen": "see", "took": "take", "taken": "take", "came": "come",
    "made": "make", "said": "say", "got": "get", "gotten": "get",
    "found": "find", "gave": "give", "given": "give", "told": "tell",
    "felt": "feel", "kept": "keep", "left": "leave", "meant": "mean",
    "met": "meet", "paid": "pay", "sat": "sit", "spoke": "speak",
    "spoken": "speak", "stood": "stand", "thought": "think", "wrote": "write",
    "written": "write", "knew": "know", "known": "know", "grew": "grow",
    "grown": "grow", "drew": "draw", "drawn": "draw", "flew": "fly",
    "flown": "fly", "threw": "throw", "thrown": "throw", "broke": "break",
    "broken": "break", "chose": "choose", "chosen": "choose", "drove": "drive",
    "driven": "drive", "fell": "fall", "fallen": "fall", "held": "hold",
    "lost": "lose", "sold": "sell", "sent": "send",
    "was": "be", "were": "be", "is": "be", "are": "be", "am": "be",
    "been": "be", "being": "be", "has": "have", "had": "have",
    "does": "do", "did": "do", "done": "do", "goes": "go",
    "men": "man", "women": "woman", "children": "child", "people": "person",
    "mice": "mouse", "geese": "goose", "feet": "foot", "teeth": "tooth",
    "better": "good", "best": "good", "worse": "bad", "worst": "bad",
}

# Words whose surface form ends like an inflection but is not one.
_NO_STRIP = {
    "this", "his", "its", "thus", "us", "bus", "gas", "yes", "news",
    "lens", "species", "series", "analysis", "basis", "crisis",
    "ring", "king", "thing", "spring", "string", "sing", "bring",
    "during", "morning", "evening", "nothing", "something", "anything",
    "everything", "red", "bed", "wed", "ted", "led", "fed", "need",
    "seed", "feed", "speed", "indeed",
}


# Words ending consonant+"oes" that are o+"es" plurals of -oe nouns, not
# -o nouns ("shoes" = shoe+s, not sho+es).
_OE_PLURALS = {
    "shoes", "canoes", "oboes", "tiptoes", "mistletoes", "throes", "floes",
}


def _has_vowel(stem: str) -> bool:
    """Porter's *v* condition: a stem with no vowel ("bl" from "bling",
    "z" from "zings") is not a word, so the suffix was not an inflection."""
    return any(c in _VOWELS or c == "y" for c in stem)


def lemmatize(word: str) -> str:
    """Suffix-rule English lemmatizer (the FastNLPProcessor.lemmatize
    analog): irregular table first, then suffix rules guarded by
    Porter-style conditions — every strip requires the remaining stem to
    contain a vowel (Porter's *v* measure guard), which is what keeps the
    rules safe on OPEN vocabulary where a closed exception list cannot
    anticipate every "bling"/"zings"-shaped token."""
    w = word.lower()
    if w in _IRREGULAR:
        return _IRREGULAR[w]
    if w in _NO_STRIP or len(w) <= 3:
        return w

    def _restore(stem: str) -> str:
        # doubled final consonant: "hopped" -> "hopp" -> "hop"
        if (
            len(stem) >= 3
            and stem[-1] == stem[-2]
            and stem[-1] not in _VOWELS
            and stem[-1] not in "ls"
        ):
            return stem[:-1]
        # silent-e restoration: "making" -> "mak" -> "make"
        if (
            len(stem) >= 3
            and stem[-1] not in _VOWELS | {"w", "x", "y"}
            and stem[-2] in _VOWELS
            and stem[-3] not in _VOWELS
            and _needs_e(stem)
        ):
            return stem + "e"
        return stem

    if w.endswith("ies") and len(w) > 4:
        return w[:-3] + "y"
    if w.endswith("ied") and len(w) > 4:  # carried -> carry, studied -> study
        return w[:-3] + "y"
    if w.endswith("sses"):
        return w[:-2]
    if w.endswith(("ches", "shes", "xes", "zes")):
        return w[:-2]
    if (
        w.endswith("oes")
        and len(w) > 4
        and w[-4] not in _VOWELS
        and w not in _OE_PLURALS
    ):
        return w[:-2]  # consonant+o takes -es: heroes/echoes/potatoes
    if w.endswith("s") and not w.endswith(("ss", "us", "is")):
        return w[:-1] if _has_vowel(w[:-1]) else w
    if w.endswith("ing") and len(w) > 5 and _has_vowel(w[:-3]):
        return _restore(w[:-3])
    if w.endswith("ed") and len(w) > 4 and _has_vowel(w[:-2]):
        return _restore(w[:-2])
    return w


def _needs_e(stem: str) -> bool:
    """Heuristic: restore silent e after stripping -ing/-ed for stems like
    mak-, writ-, driv-, tak-, encod- (single vowel + single final consonant
    that commonly ends an e-final base)."""
    return stem[-1] in set("kvztcgud") or stem.endswith(("at", "it", "ot", "ut"))


# Compact gazetteers — the reference resolves these through CoreNLP's models.
_PERSON_NAMES = {
    "john", "mary", "james", "robert", "michael", "william", "david",
    "richard", "joseph", "thomas", "charles", "chris", "daniel", "matthew",
    "anthony", "mark", "donald", "steven", "paul", "andrew", "joshua",
    "kenneth", "kevin", "brian", "george", "timothy", "ronald", "jason",
    "edward", "jeffrey", "ryan", "jacob", "gary", "nicholas", "eric",
    "jonathan", "stephen", "larry", "justin", "scott", "brandon", "benjamin",
    "samuel", "gregory", "alexander", "patrick", "frank", "raymond", "jack",
    "dennis", "jerry", "tyler", "aaron", "jose", "adam", "nathan", "henry",
    "peter", "zachary", "kyle", "noah", "alan", "ethan", "jeremy", "walter",
    "christian", "keith", "roger", "terry", "austin", "sean", "gerald",
    "carl", "harold", "dylan", "arthur", "lawrence", "jordan", "jesse",
    "bryan", "billy", "bruce", "gabriel", "joe", "logan", "alex", "juan",
    "albert", "willie", "elijah", "wayne", "randy", "vincent", "mason",
    "roy", "ralph", "bobby", "russell", "bradley", "philip", "eugene",
    "patricia", "jennifer", "linda", "elizabeth", "barbara", "susan",
    "jessica", "sarah", "karen", "lisa", "nancy", "betty", "sandra",
    "margaret", "ashley", "kimberly", "emily", "donna", "michelle", "carol",
    "amanda", "dorothy", "melissa", "deborah", "stephanie", "rebecca",
    "sharon", "laura", "cynthia", "kathleen", "amy", "angela", "shirley",
    "anna", "brenda", "pamela", "emma", "nicole", "helen", "samantha",
    "katherine", "christine", "debra", "rachel", "carolyn", "janet",
    "catherine", "maria", "heather", "diane", "ruth", "julie", "olivia",
    "joyce", "virginia", "victoria", "kelly", "lauren", "christina", "joan",
    "evelyn", "judith", "megan", "andrea", "cheryl", "hannah", "jacqueline",
    "martha", "gloria", "teresa", "ann", "sara", "madison", "frances",
    "kathryn", "janice", "jean", "abigail", "alice", "judy", "sophia",
    "grace", "denise", "amber", "doris", "marilyn", "danielle", "beverly",
    "isabella", "theresa", "diana", "natalie", "brittany", "charlotte",
}
_LOCATIONS = {
    # US states
    "alabama", "alaska", "arizona", "arkansas", "california", "colorado",
    "connecticut", "delaware", "florida", "georgia", "hawaii", "idaho",
    "illinois", "indiana", "iowa", "kansas", "kentucky", "louisiana",
    "maine", "maryland", "massachusetts", "michigan", "minnesota",
    "mississippi", "missouri", "montana", "nebraska", "nevada", "ohio",
    "oklahoma", "oregon", "pennsylvania", "tennessee", "texas", "utah",
    "vermont", "virginia", "washington", "wisconsin", "wyoming",
    # countries
    "america", "canada", "mexico", "brazil", "argentina", "england",
    "britain", "france", "germany", "spain", "italy", "portugal", "ireland",
    "scotland", "russia", "china", "japan", "korea", "india", "australia",
    "egypt", "israel", "turkey", "greece", "poland", "sweden", "norway",
    "denmark", "finland", "netherlands", "belgium", "switzerland", "austria",
    "ukraine", "iran", "iraq", "afghanistan", "pakistan", "vietnam",
    "thailand", "indonesia", "philippines", "nigeria", "kenya", "ethiopia",
    # major cities
    "london", "paris", "berlin", "madrid", "rome", "moscow", "beijing",
    "shanghai", "tokyo", "seoul", "delhi", "mumbai", "sydney", "toronto",
    "chicago", "boston", "seattle", "houston", "dallas", "denver", "miami",
    "atlanta", "philadelphia", "phoenix", "detroit", "baltimore",
}
_ORG_SUFFIXES = {
    "inc", "corp", "corporation", "company", "co", "ltd", "llc", "group",
    "university", "college", "institute", "association", "committee",
    "department", "agency", "bureau", "ministry", "bank", "press",
}
_ORG_NAMES = {
    "google", "microsoft", "apple", "amazon", "facebook", "ibm", "intel",
    "oracle", "netflix", "tesla", "boeing", "toyota", "honda", "sony",
    "samsung", "nasa", "fbi", "cia", "nato", "congress", "senate", "nyse",
}


def _entity_type(token: str, capitalized: bool, next_lower: str | None) -> str | None:
    """NER analog: entity type or None (CoreNLP tags 'O' for non-entities)."""
    low = token.lower()
    if _NUMERIC.match(token):
        return "NUMBER"
    if low in _ORG_NAMES:
        return "ORGANIZATION"
    if capitalized:
        if next_lower in _ORG_SUFFIXES:
            return "ORGANIZATION"
        if low in _PERSON_NAMES:
            return "PERSON"
        if low in _LOCATIONS:
            return "LOCATION"
        if low in _ORG_SUFFIXES:
            return "ORGANIZATION"
    return None


def normalize(s: str) -> str:
    """Strip non-alphanumerics and lowercase (reference :41-44)."""
    return _NON_ALNUM.sub("", s).lower()


class CoreNLPFeatureExtractor(Transformer):
    """Tokenize -> lemmatize -> entity-replace -> sentence-bounded n-grams
    (reference CoreNLPFeatureExtractor.scala:18-45).  Input: a batch of
    document strings; output: per document, the list of space-joined n-gram
    strings for every requested order."""

    def __init__(self, orders: Sequence[int]):
        self.orders = list(orders)

    def apply_item(self, doc: str) -> list:
        sentences = []
        for sent in _SENT_SPLIT.split(doc):
            raw = _TOKEN.findall(sent)
            if not raw:
                continue
            out = []
            for i, tok in enumerate(raw):
                nxt = raw[i + 1].lower() if i + 1 < len(raw) else None
                ent = _entity_type(tok, tok[:1].isupper(), nxt)
                if ent is not None:
                    out.append(ent)
                elif tok[:1].isdigit():
                    # digit-led mixed token ("90s", "3d"): unit/decade
                    # notation, not an English inflection — don't let the
                    # suffix lemmatizer strip it ("90s" -> "90")
                    out.append(normalize(tok))
                else:
                    out.append(normalize(lemmatize(tok)))
            sentences.append(out)
        grams = []
        for n in self.orders:
            for s in sentences:
                for i in range(len(s) - n + 1):
                    grams.append(" ".join(s[i : i + n]))
        return grams

    def __call__(self, batch: Sequence[str]):
        return [self.apply_item(doc) for doc in batch]
