"""Planted-signal synthetic world: learnable scenes with ground-truth answers.

The PyTorch port's own copy of ``dfol_vqa_tpu/data/planted.py``, which it must not import
(the port imports nothing of the JAX package); it behaves exactly as
that module, and tests/test_torch_host.py holds the two equal.

Validates the framework's core claim end-to-end — that the visual oracle
learns real concepts from ANSWER-ONLY supervision through the differentiable
logic — without the GQA download. Each scene's objects carry ground-truth
concepts (a noun, one value per attribute category), box features are a fixed
random linear encoding of those concepts plus noise, and spatial relations
derive from box geometry. Question answers are computed by exact boolean
evaluation of the program against the ground truth, so accuracy measures
genuine concept learning.

Supports every terminal-op family of the GQA program ontology
(reference: src/nsvqa/nn/interpreter/batch_gqa_ops.py:160-902), enabling the
full 8-stage curriculum of the reference README (README.md:77-100) to run
end-to-end on synthetic data.
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from dfol_vqa_tpu_torch.data.features import FeatureSource
from dfol_vqa_tpu_torch.ontology import GQAOntology

# Preference order for planted attribute categories (all have >=4 options in
# the GQA vocabulary; see gqa_all_attribute.json).
_CATEGORY_PREFERENCE = ["color", "material", "size", "shape", "state", "cleanliness"]

ALL_FAMILIES = (
    "exist", "verify_attrs", "verify_rel", "query_attr", "choose_attr",
    "choose_rel", "and", "or", "two_same", "two_different",
    "all_same", "all_different", "compare",
)


def _strip_neg(tok) -> Tuple[object, bool]:
    # Non-string tokens (None, wildcard sentinels) carry no negation.
    if not isinstance(tok, str):
        return tok, False
    if tok.startswith("not(") and tok.endswith(")"):
        return tok[4:-1], True
    return tok, False


class PlantedWorld(FeatureSource):
    """Scenes with planted concepts + exact question/answer generation.

    Attributes are structured by category: each object holds exactly ONE value
    per planted category (like GQA color/material/...), which makes
    query/choose/same/compare questions well-posed.
    """

    def __init__(
        self,
        ontology: GQAOntology,
        box_dim: int = 2048,
        n_nouns: int = 8,
        n_attrs: int = 6,
        n_images: int = 256,
        min_objects: int = 4,
        max_objects: int = 12,
        noise: float = 0.1,
        seed: int = 0,
        image_id_space: str = "planted",
    ):
        """`image_id_space='vocab'` names scenes with real GQA image ids so
        questions survive the H5 int codec (encode_img_id needs vocabulary
        membership); 'planted' keeps the legacy synthetic names."""
        self.box_dim = box_dim
        self._seed = seed
        rng = np.random.default_rng(seed)
        self._rng = rng
        nouns = [t for t in ontology._nouns if t in ontology._arg_to_idx]
        self.nouns = [str(t) for t in rng.choice(nouns, n_nouns, replace=False)]

        # Distribute n_attrs option slots round-robin over the category
        # preference list (>=2 options per used category so query/choose/same
        # questions are non-trivial).
        n_cats = max(1, min(len(_CATEGORY_PREFERENCE), n_attrs // 2))
        per_cat = [n_attrs // n_cats + (1 if i < n_attrs % n_cats else 0)
                   for i in range(n_cats)]
        self.categories: List[Tuple[str, List[str]]] = []
        for cat_name, k in zip(_CATEGORY_PREFERENCE, per_cat):
            opts = [o for o in ontology.query(cat_name) if o in ontology._arg_to_idx]
            take = [str(o) for o in rng.choice(opts, min(k, len(opts)), replace=False)]
            self.categories.append((cat_name, take))
        # flat option list (kept for backward compatibility: filter tokens)
        self.attrs: List[str] = [o for _, opts in self.categories for o in opts]
        self._opt_cat: Dict[str, int] = {}
        for ci, (_, opts) in enumerate(self.categories):
            for o in opts:
                self._opt_cat[o] = ci

        # left/right spatial relations derived from geometry
        self.relations = ["to the left of", "to the right of"]
        n_feat = n_nouns + len(self.attrs)
        self._codebook = rng.standard_normal((n_feat, box_dim)).astype(np.float32)
        self._noise = noise

        self._scenes: Dict[str, dict] = {}
        if image_id_space == "vocab":
            id_pool = ontology._images
        for i in range(n_images):
            img = id_pool[i] if image_id_space == "vocab" else f"planted_{i}"
            n = int(rng.integers(min_objects, max_objects + 1))
            noun_ids = rng.integers(0, n_nouns, n)
            cat_vals = np.stack(
                [rng.integers(0, len(opts), n) for _, opts in self.categories], axis=1
            )  # (n, n_cats)
            x = rng.uniform(0, 600, n)
            y = rng.uniform(0, 440, n)
            w = rng.uniform(5, 40, n)
            h = rng.uniform(5, 40, n)
            self._scenes[img] = dict(
                n=n, noun_ids=noun_ids, cat_vals=cat_vals, x=x, y=y, w=w, h=h
            )

    @property
    def image_ids(self) -> List[str]:
        return list(self._scenes.keys())

    # ------------------------------------------------------------- features

    def image(self, image_id: str) -> Tuple[np.ndarray, int]:
        s = self._scenes[image_id]
        n = s["n"]
        n_nouns = len(self.nouns)
        onehot = np.zeros((n, n_nouns + len(self.attrs)), np.float32)
        onehot[np.arange(n), s["noun_ids"]] = 1.0
        off = n_nouns
        for ci, (_, opts) in enumerate(self.categories):
            onehot[np.arange(n), off + s["cat_vals"][:, ci]] = 1.0
            off += len(opts)
        # Process-independent noise seed: builtin hash() is PYTHONHASHSEED-
        # randomized across interpreters, which would give the subprocess-per-
        # stage curriculum a different noise realization of the same scene in
        # every stage. crc32 is stable everywhere; fold in the world seed so
        # distinct worlds get distinct noise streams.
        h = (zlib.crc32(f"noise/{image_id}".encode()) ^ (self._seed * 0x9E3779B1)) % (2**32)
        nrng = np.random.default_rng(h)
        feats = onehot @ self._codebook + self._noise * nrng.standard_normal(
            (n, self.box_dim)
        ).astype(np.float32)
        out = np.zeros((n, self.box_dim + 6), np.float32)
        out[:, : self.box_dim] = feats
        out[:, self.box_dim] = 640
        out[:, self.box_dim + 1] = 480
        out[:, self.box_dim + 2] = s["x"]
        out[:, self.box_dim + 3] = s["y"]
        out[:, self.box_dim + 4] = s["w"]
        out[:, self.box_dim + 5] = s["h"]
        return out, n

    # ---------------------------------------------------------- ground truth

    def _holds_attr(self, s, obj: int, token: str) -> bool:
        token, neg = _strip_neg(token)
        if token in ("_", "scene", None):
            holds = True
        elif token in self.nouns:
            holds = s["noun_ids"][obj] == self.nouns.index(token)
        elif token in self._opt_cat:
            ci = self._opt_cat[token]
            holds = self.categories[ci][1][s["cat_vals"][obj, ci]] == token
        else:
            holds = False
        return holds != neg

    def _holds_rel(self, s, subj: int, obj: int, rel: str) -> bool:
        """rel(subject, object): "subject is <rel> object"."""
        cx_i = s["x"][subj] + s["w"][subj] / 2
        cx_j = s["x"][obj] + s["w"][obj] / 2
        if rel == "to the left of":
            return cx_i < cx_j
        if rel == "to the right of":
            return cx_i > cx_j
        return False

    def eval_branch(self, image_id: str, branch: List[dict]) -> np.ndarray:
        """Boolean object-set evaluation of a select/filter/relate chain."""
        s = self._scenes[image_id]
        n = s["n"]
        cur = np.ones(n, bool)
        for op in branch:
            if op["operator"] == "select":
                a = op["arguments"][0]
                if a not in ("_", "scene", None):
                    cur &= np.array([self._holds_attr(s, o, a) for o in range(n)])
            elif op["operator"] == "filter":
                a = op["arguments"][0]
                cur &= np.array([self._holds_attr(s, o, a) for o in range(n)])
            elif op["operator"] == "relate":
                rel, is_subject, aux = op["arguments"]
                rel, neg = _strip_neg(rel)
                new = np.array([self._holds_attr(s, o, aux) for o in range(n)])
                nxt = np.zeros(n, bool)
                for o in range(n):
                    if not new[o]:
                        continue
                    for p in range(n):
                        if p == o or not cur[p]:
                            continue
                        holds = (
                            self._holds_rel(s, o, p, rel)
                            if is_subject
                            else self._holds_rel(s, p, o, rel)
                        )
                        if holds != neg:
                            nxt[o] = True
                            break
                cur = nxt
        return cur

    # ------------------------------------------------------------- questions

    def generate(self, n: int, hops: int = 1, seed: int = 0, balance: bool = True) -> List[dict]:
        """Exist questions with ground-truth answers (optionally balanced).

        Kept for backward compatibility; `hops` counts total branch ops
        (select included), matching round-1 callers."""
        rng = np.random.default_rng(seed)
        out = []
        want_yes = True
        guard = 0
        while len(out) < n and guard < n * 200:
            guard += 1
            img = self.image_ids[int(rng.integers(0, len(self._scenes)))]
            ops = [{"operator": "select", "arguments": [str(rng.choice(self.nouns))]}]
            for hop in range(hops - 1):
                if hop == 0 and hops > 1 and rng.uniform() < 0.5:
                    ops.append(
                        {
                            "operator": "relate",
                            "arguments": [str(rng.choice(self.relations)), True,
                                          str(rng.choice(self.nouns))],
                        }
                    )
                else:
                    ops.append({"operator": "filter", "arguments": [str(rng.choice(self.attrs))]})
            ans = "yes" if self.eval_branch(img, ops).any() else "no"
            if balance and ((ans == "yes") != want_yes):
                continue
            want_yes = not want_yes
            out.append(
                {
                    "program": {"branches": [ops], "last_op": {"operator": "exist", "arguments": []}},
                    "answer": ans,
                    "imageId": img,
                    "question_id": f"p{len(out)}",
                }
            )
        return out

    # ------------------------------------------- full-family generation

    def _scene_ids(self, image_slice: Optional[Tuple[float, float]]) -> List[str]:
        ids = self.image_ids
        if image_slice is None:
            return ids
        lo = int(image_slice[0] * len(ids))
        hi = int(image_slice[1] * len(ids))
        return ids[lo:hi]

    def _unique_objs(self, s) -> List[int]:
        """Objects whose noun appears exactly once in the scene."""
        counts = np.bincount(s["noun_ids"], minlength=len(self.nouns))
        return [o for o in range(s["n"]) if counts[s["noun_ids"][o]] == 1]

    def _pin_branch(self, rng, s, obj: int, length: int,
                    exclude_cat: Optional[int] = None) -> List[dict]:
        """select+filters branch that evaluates to exactly {obj} under
        eval_branch; filters use the object's own category values.

        `exclude_cat` bars a category from the filter pool so the queried/
        compared category's value never appears verbatim in the program (the
        model could otherwise read the answer off the question tokens). When
        exclusion empties the pool, the object's own noun is used as the
        filter token — still pinning, never leaking."""
        noun = self.nouns[s["noun_ids"][obj]]
        ops = [{"operator": "select", "arguments": [noun]}]
        pool = [ci for ci in range(len(self.categories)) if ci != exclude_cat]
        for _ in range(length):
            if pool:
                ci = int(rng.choice(pool))
                val = self.categories[ci][1][s["cat_vals"][obj, ci]]
            else:
                val = noun
            ops.append({"operator": "filter", "arguments": [str(val)]})
        return ops

    def _free_branch(self, rng, length: int, neg_prob: float = 0.0,
                     wildcard_prob: float = 0.0) -> List[dict]:
        sel = "_" if rng.uniform() < wildcard_prob else str(rng.choice(self.nouns))
        ops = [{"operator": "select", "arguments": [sel]}]
        for _ in range(length):
            if rng.uniform() < 0.3:
                ops.append({"operator": "relate",
                            "arguments": [str(rng.choice(self.relations)),
                                          bool(rng.uniform() < 0.5),
                                          str(rng.choice(self.nouns))]})
            else:
                tok = str(rng.choice(self.attrs))
                if rng.uniform() < neg_prob:
                    tok = f"not({tok})"
                ops.append({"operator": "filter", "arguments": [tok]})
        return ops

    def generate_family(
        self,
        terminal: str,
        n: int,
        length: int = 0,
        seed: int = 0,
        balanced: bool = True,
        neg_prob: float = 0.0,
        image_slice: Optional[Tuple[float, float]] = None,
        id_prefix: str = "pf",
    ) -> List[dict]:
        """Generate `n` well-posed questions of family `terminal` with exact
        ground-truth answers; `length` = filter/relate hops beyond select.

        `balanced` alternates binary answers / rotates option answers (the
        reference's Train-Balanced analog); unbalanced keeps the natural
        generation skew (Train-All analog). `image_slice=(lo,hi)` restricts
        scenes to a fraction of the image pool so train/test scene splits are
        disjoint."""
        rng = np.random.default_rng(seed)
        ids = self._scene_ids(image_slice)
        out: List[dict] = []
        want_yes = True
        rotate = 0
        guard = 0
        max_guard = n * 500

        def scene(img):
            return self._scenes[img]

        def emit(branches, last, ans):
            out.append({
                "program": {"branches": branches, "last_op": last},
                "answer": ans,
                "imageId": img,
                "question_id": f"{id_prefix}{len(out)}",
            })

        def take_binary(ans: str) -> bool:
            nonlocal want_yes
            if balanced and ((ans == "yes") != want_yes):
                return False
            want_yes = not want_yes
            return True

        while len(out) < n and guard < max_guard:
            guard += 1
            img = str(rng.choice(ids))
            s = scene(img)

            if terminal == "exist":
                ops = self._free_branch(rng, length, neg_prob)
                ans = "yes" if self.eval_branch(img, ops).any() else "no"
                if take_binary(ans):
                    emit([ops], {"operator": "exist", "arguments": []}, ans)

            elif terminal == "verify_attrs":
                ops = self._free_branch(rng, length, neg_prob)
                cur = self.eval_branch(img, ops)
                k = int(rng.integers(1, 3))
                attrs = [str(a) for a in rng.choice(self.attrs, k, replace=False)]
                ok = any(cur[o] and all(self._holds_attr(s, o, a) for a in attrs)
                         for o in range(s["n"]))
                ans = "yes" if ok else "no"
                if take_binary(ans):
                    emit([ops], {"operator": "verify_attrs", "arguments": [attrs]}, ans)

            elif terminal == "verify_rel":
                ops = self._free_branch(rng, max(0, length - 1), neg_prob)
                rel = str(rng.choice(self.relations))
                is_subject = bool(rng.uniform() < 0.5)
                aux = str(rng.choice(self.nouns))
                probe = ops + [{"operator": "relate", "arguments": [rel, is_subject, aux]}]
                ans = "yes" if self.eval_branch(img, probe).any() else "no"
                if take_binary(ans):
                    emit([ops], {"operator": "verify_rel",
                                 "arguments": [rel, is_subject, aux]}, ans)

            elif terminal in ("query_attr", "choose_attr"):
                uniq = self._unique_objs(s)
                if not uniq:
                    continue
                obj = int(rng.choice(uniq))
                # Pick the queried category FIRST and exclude it from the pin
                # filters, so the answer never appears verbatim in the program.
                ci = int(rng.integers(0, len(self.categories)))
                cat_name, opts = self.categories[ci]
                if len(opts) < 2:
                    continue
                ops = self._pin_branch(rng, s, obj, length, exclude_cat=ci)
                val = opts[s["cat_vals"][obj, ci]]
                if terminal == "query_attr":
                    if balanced and opts.index(val) != rotate % len(opts):
                        continue
                    rotate += 1
                    emit([ops], {"operator": "query_attr", "arguments": [cat_name]}, val)
                else:
                    distract = str(rng.choice([o for o in opts if o != val]))
                    pair = [val, distract] if rng.uniform() < 0.5 else [distract, val]
                    emit([ops], {"operator": "choose_attr", "arguments": [pair]}, val)

            elif terminal == "choose_rel":
                uniq = self._unique_objs(s)
                if len(uniq) < 2:
                    continue
                a, b = (int(v) for v in rng.choice(uniq, 2, replace=False))
                ops = self._pin_branch(rng, s, b, max(0, length - 1))
                is_subject = bool(rng.uniform() < 0.5)
                # which of the two relations holds for (aux=a, branch=b)?
                subj, obj = (a, b) if is_subject else (b, a)
                truth = next(r for r in self.relations if self._holds_rel(s, subj, obj, r))
                other = next(r for r in self.relations if r != truth)
                pair = [truth, other] if rng.uniform() < 0.5 else [other, truth]
                aux = self.nouns[s["noun_ids"][a]]
                emit([ops], {"operator": "choose_rel",
                             "arguments": [pair, is_subject, aux]}, truth)

            elif terminal in ("and", "or"):
                b1 = self._free_branch(rng, length, neg_prob)
                b2 = self._free_branch(rng, length, neg_prob)
                e1 = self.eval_branch(img, b1).any()
                e2 = self.eval_branch(img, b2).any()
                ok = (e1 and e2) if terminal == "and" else (e1 or e2)
                ans = "yes" if ok else "no"
                if take_binary(ans):
                    emit([b1, b2], {"operator": terminal, "arguments": []}, ans)

            elif terminal in ("two_same", "two_different"):
                uniq = self._unique_objs(s)
                if len(uniq) < 2:
                    continue
                o1, o2 = (int(v) for v in rng.choice(uniq, 2, replace=False))
                ci = int(rng.integers(0, len(self.categories)))
                cat_name, opts = self.categories[ci]
                same = s["cat_vals"][o1, ci] == s["cat_vals"][o2, ci]
                ok = same if terminal == "two_same" else not same
                ans = "yes" if ok else "no"
                if take_binary(ans):
                    emit([self._pin_branch(rng, s, o1, length, exclude_cat=ci),
                          self._pin_branch(rng, s, o2, length, exclude_cat=ci)],
                         {"operator": terminal, "arguments": [cat_name]}, ans)

            elif terminal in ("all_same", "all_different"):
                ops = self._free_branch(rng, length, neg_prob)
                cur = self.eval_branch(img, ops)
                members = np.flatnonzero(cur)
                if len(members) < 2:
                    continue
                ci = int(rng.integers(0, len(self.categories)))
                cat_name, _ = self.categories[ci]
                vals = s["cat_vals"][members, ci]
                same = bool((vals == vals[0]).all())
                ok = same if terminal == "all_same" else not same
                ans = "yes" if ok else "no"
                if take_binary(ans):
                    emit([ops], {"operator": terminal, "arguments": [cat_name]}, ans)

            elif terminal == "compare":
                uniq = self._unique_objs(s)
                if len(uniq) < 2:
                    continue
                o1, o2 = (int(v) for v in rng.choice(uniq, 2, replace=False))
                ci = int(rng.integers(0, len(self.categories)))
                _, opts = self.categories[ci]
                v1, v2 = s["cat_vals"][o1, ci], s["cat_vals"][o2, ci]
                if v1 == v2:
                    continue
                attr = opts[v1]  # o1 holds attr, o2 does not
                is_less = bool(rng.uniform() < 0.5)
                # is_less=False: answer = branch with attr (GQACompareBatch
                # log_parametric_not alpha flip, batch_gqa_ops.py:736-739)
                winner = o2 if is_less else o1
                ans = self.nouns[s["noun_ids"][winner]]
                emit([self._pin_branch(rng, s, o1, length, exclude_cat=ci),
                      self._pin_branch(rng, s, o2, length, exclude_cat=ci)],
                     {"operator": "compare", "arguments": [str(attr), is_less]}, ans)

            else:
                raise ValueError(terminal)

        if len(out) < n:
            raise RuntimeError(
                f"generate_family({terminal}): only {len(out)}/{n} questions "
                f"after {guard} attempts — relax constraints or grow the world"
            )
        return out
