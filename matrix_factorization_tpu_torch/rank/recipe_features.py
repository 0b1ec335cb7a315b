"""Recipe text parsing + structured features (pure host-side functions; a
copy of ``matrix_factorization_tpu/rank/recipe_features.py``).

Behavior-parity rewrite of ``project_template/app/recipe_features.py``
(reference ``:18-352``): ingredient parsing, cook-time extraction, 8
allergen flags, protein / low-calorie heuristic scores, avoid-term synonym
expansion, Jaccard overlap.  These feed three consumers: UI hard filters,
the metadata builder, and the reranker featurizer.

Not a hot path (ran once per catalog build), so plain Python/regex is the
right tool; batch helpers at the bottom vectorize over a pandas column for
the pipeline.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Set, Tuple

# --------------------------------------------------------------------------
# term utilities
# --------------------------------------------------------------------------

_SPLIT_RE = re.compile(r"[，,;；\n]+")


def split_terms(raw: Optional[str]) -> List[str]:
    """Split a free-text term list on ASCII/CJK delimiters."""
    if raw is None:
        return []
    return [p.strip() for p in _SPLIT_RE.split(str(raw)) if p.strip()]


def contains_any(text: Optional[str], terms: List[str]) -> bool:
    """Case-insensitive substring match against any term."""
    if not terms:
        return False
    hay = (text or "").lower()
    return any(str(t).lower() in hay for t in terms)


# --------------------------------------------------------------------------
# item-text structure: "title: ...\ningredients: a; b\ndirections: ..."
# (format produced by the recipes prep pipeline)
# --------------------------------------------------------------------------


def _line_after(text: Optional[str], prefix: str) -> str:
    if not text:
        return ""
    for ln in str(text).splitlines():
        ln = ln.strip()
        if ln.lower().startswith(prefix):
            return ln.split(":", 1)[1].strip()
    return ""


def extract_ingredient_phrases(text: Optional[str]) -> Set[str]:
    """Phrase set from the ``ingredients:`` line of an item text."""
    ing_line = _line_after(text, "ingredients:")
    if not ing_line:
        return set()
    out = set()
    for part in re.split(r"[;；,，]+", ing_line):
        s = re.sub(r"\s+", " ", part.strip().lower())
        if s:
            out.add(s)
    return out


def extract_directions_text(text: Optional[str]) -> str:
    return _line_after(text, "directions:")


_RANGE_RE = re.compile(r"(\d+)\s*(?:-|to)\s*(\d+)\s*(?:minutes?|mins?)")
_MIN_RE = re.compile(r"(\d+)\s*(?:minutes?|mins?)")
_HR_RE = re.compile(r"(\d+)\s*(?:hours?|hrs?|hr)\b")


def extract_time_minutes(text: Optional[str]) -> Optional[int]:
    """Rough cook time in minutes from the directions line.

    Ranges take the upper bound ("10-15 minutes" -> 15); otherwise first
    hour mention * 60 + first minute mention.
    """
    d = extract_directions_text(text).lower()
    if not d:
        return None
    m = _RANGE_RE.search(d)
    if m:
        return int(m.group(2))
    total = 0
    hrs = _HR_RE.findall(d)
    if hrs:
        total += 60 * int(hrs[0])
    mins = _MIN_RE.findall(d)
    if mins:
        total += int(mins[0])
    return total if total > 0 else None


# --------------------------------------------------------------------------
# allergen flags
# --------------------------------------------------------------------------

ALLERGEN_WORDS: Dict[str, List[str]] = {
    "tree_nuts": [
        "almond", "walnut", "pecan", "cashew", "pistachio", "hazelnut",
        "macadamia", "pine nut", "brazil nut",
    ],
    "dairy": [
        "milk", "cheese", "cream", "butter", "yogurt", "sour cream",
        "buttermilk", "whey", "half and half", "condensed milk",
        "evaporated milk",
    ],
    "egg": ["egg", "eggs"],
    "wheat": ["wheat", "flour", "bread", "pasta", "noodle", "breadcrumbs",
              "cracker"],
    "soy": ["soy", "soy sauce", "tofu", "edamame"],
    "fish": ["fish", "salmon", "tuna", "cod", "tilapia", "trout", "sardine"],
    "shellfish": ["shrimp", "prawn", "crab", "lobster", "clam", "mussel",
                  "oyster", "scallop"],
}


@dataclass(frozen=True)
class RecipeFlags:
    has_peanut: bool
    has_tree_nuts: bool
    has_dairy: bool
    has_egg: bool
    has_wheat: bool
    has_soy: bool
    has_fish: bool
    has_shellfish: bool


def compute_flags(ingredients: Iterable[str]) -> RecipeFlags:
    """8 allergen booleans from the ingredient phrase set."""
    ing = " ; ".join(str(x).lower() for x in ingredients if x)

    def hit(words: List[str]) -> bool:
        return any(w in ing for w in words)

    return RecipeFlags(
        has_peanut="peanut" in ing,
        has_tree_nuts=("nuts" in ing) or hit(ALLERGEN_WORDS["tree_nuts"]),
        has_dairy=("dairy" in ing) or hit(ALLERGEN_WORDS["dairy"]),
        has_egg=hit(ALLERGEN_WORDS["egg"]),
        has_wheat=hit(ALLERGEN_WORDS["wheat"]),
        has_soy=hit(ALLERGEN_WORDS["soy"]),
        has_fish=hit(ALLERGEN_WORDS["fish"]),
        has_shellfish=hit(ALLERGEN_WORDS["shellfish"]),
    )


# --------------------------------------------------------------------------
# protein / low-calorie heuristics
# --------------------------------------------------------------------------

PROTEIN_WORDS: List[str] = [
    "chicken breast", "chicken", "turkey", "tuna", "salmon", "shrimp",
    "prawn", "lean beef", "beef", "pork loin", "pork", "fish", "tofu",
    "tempeh", "lentil", "lentils", "beans", "black beans", "kidney beans",
    "chickpea", "chickpeas", "garbanzo", "edamame", "egg", "eggs",
    "greek yogurt", "cottage cheese",
]

HIGH_CAL_WORDS: List[str] = [
    "oil", "olive oil", "vegetable oil", "canola oil", "shortening", "lard",
    "butter", "margarine",
    "sugar", "brown sugar", "powdered sugar", "confectioners sugar",
    "corn syrup", "honey", "maple syrup", "chocolate", "chips",
    "cream", "heavy cream", "whipping cream", "sour cream", "cheese",
    "cream cheese", "condensed milk",
    "bacon", "sausage", "pepperoni", "mayonnaise",
]

LOW_CAL_HINT_WORDS: List[str] = [
    "low calorie", "low-calorie", "low fat", "low-fat", "fat free",
    "fat-free", "light", "lite", "sugar-free", "sugar free", "skinless",
    "lean",
]

FRY_WORDS = ["fry", "fried", "deep fry", "deep-fry", "pan-fry"]
LIGHT_COOK_WORDS = ["steam", "steamed", "grill", "grilled", "bake", "baked",
                    "roast", "roasted"]


def compute_protein_score(ingredients: Iterable[str]) -> float:
    """Count-based high-protein heuristic: +1 per protein word hit, +0.5
    for an explicit 'protein' mention."""
    ing = " ; ".join(str(x).lower() for x in ingredients if x)
    if not ing:
        return 0.0
    score = float(sum(1.0 for w in PROTEIN_WORDS if w in ing))
    if "protein" in ing:
        score += 0.5
    return score


def parse_query_intent(query: Optional[str]) -> Dict[str, bool]:
    q = (query or "").lower()
    return {
        "want_high_protein": ("high protein" in q)
        or ("protein" in q and "low protein" not in q),
        "want_low_calorie": ("low calorie" in q) or ("low-calorie" in q),
    }


def compute_low_calorie_score(
    *, ingredients: Iterable[str], directions: str
) -> Tuple[float, float]:
    """(low_calorie_score, high_calorie_penalty).

    penalty: +1 per high-cal ingredient hit (capped 8), +2 if fried.
    score: +1 per explicit low-cal hint (capped 4), +0.5 for light cooking.
    low_cal = clip(score - 0.5 * penalty, 0, 5).
    """
    ing = " ; ".join(str(x).lower() for x in ingredients if x)
    d = (directions or "").lower()

    penalty = min(float(sum(1.0 for w in HIGH_CAL_WORDS if w in ing)), 8.0)
    if any(w in d for w in FRY_WORDS):
        penalty += 2.0

    score = min(
        float(sum(1.0 for w in LOW_CAL_HINT_WORDS if w in ing or w in d)), 4.0
    )
    if any(w in d for w in LIGHT_COOK_WORDS):
        score += 0.5

    low_cal = max(0.0, min(5.0, score - 0.5 * penalty))
    return float(low_cal), float(penalty)


# --------------------------------------------------------------------------
# avoid-term expansion + overlap
# --------------------------------------------------------------------------


def expand_avoid_terms(terms: List[str], *, enable: bool) -> List[str]:
    """Expand avoid words into stricter synonym sets for hard filtering
    (milk -> dairy words, nuts -> tree-nut words).  Over-filtering is the
    intended bias."""
    base = [str(t).strip().lower() for t in (terms or []) if str(t).strip()]
    if not enable:
        return base

    out: List[str] = list(base)

    def add(xs: List[str]) -> None:
        for x in xs:
            xl = str(x).strip().lower()
            if xl and xl not in out:
                out.append(xl)

    if "milk" in base or "dairy" in base:
        add(ALLERGEN_WORDS["dairy"])
        add(["dairy"])
    if "nuts" in base or "nut" in base:
        add(ALLERGEN_WORDS["tree_nuts"])
        add(["nuts", "nut"])
    if "peanut" in base:
        # recipes often say just "nuts"; deliberately NOT expanded to all
        # tree nuts to avoid over-filtering
        add(["peanut", "peanuts"])
    return out


def jaccard(a: Set[str], b: Set[str]) -> float:
    if not a or not b:
        return 0.0
    inter = len(a & b)
    if inter == 0:
        return 0.0
    union = len(a | b)
    return float(inter / union) if union else 0.0


# --------------------------------------------------------------------------
# batch helpers for the pipeline (vectorized over a text column)
# --------------------------------------------------------------------------


def featurize_item_text(text: Optional[str]) -> Dict[str, object]:
    """All structured features of one item text (metadata builder row)."""
    ings = extract_ingredient_phrases(text)
    directions = extract_directions_text(text)
    flags = compute_flags(ings)
    low_cal, high_pen = compute_low_calorie_score(
        ingredients=ings, directions=directions
    )
    return {
        "time_min": extract_time_minutes(text),
        "ingredients_count": len(ings),
        "protein_score": compute_protein_score(ings),
        "low_calorie_score": low_cal,
        "high_calorie_penalty": high_pen,
        **{f"has_{k}": getattr(flags, f"has_{k}") for k in (
            "peanut", "tree_nuts", "dairy", "egg", "wheat", "soy", "fish",
            "shellfish",
        )},
    }
