"""Planted scenes and exact questions: the benchmark's traffic generator.

The scene model and the question families follow the port's planted world
(every object holds one noun and one value per planted attribute category;
box features are a fixed random code of those concepts plus noise, and the
left/right relations follow from the boxes), written here in bulk numpy so
that thousands of scenes and questions are made in set-up within seconds:

* every scene's features are made at once into one ``(scenes, O, D+6)``
  array, padded to ``O`` objects, with the object mask beside it;
* a branch (select, filter, relate) is evaluated on boolean vectors and
  one ``(n, n)`` relation matrix per scene, never object by object.

A ``World`` holds the scenes both sides read (``image``, ``scene``): the
program through a feature source of its own kind (``benchmark/scenes.py``),
the reference through the frozen copy's (``reference.features.Scenes``).
numpy only.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from benchmark.reference.ontology import GQAOntology

# the categories the planted attributes come from, in order of preference
# (each has four or more values in the GQA vocabulary)
CATEGORY_PREFERENCE = ("color", "material", "size", "shape", "state", "cleanliness")
RELATIONS = ("to the left of", "to the right of")
FAMILIES = ("exist", "end", "verify_attrs", "verify_rel", "query_attr", "choose_attr",
            "choose_rel", "and", "or", "two_same", "two_different", "all_same",
            "all_different", "compare")


class World:
    """``n_scenes`` scenes of ``min_objects``..``max_objects`` objects over
    ``n_nouns`` nouns and ``n_attrs`` attribute values, padded to
    ``object_num`` slots, all drawn from ``seed``."""

    def __init__(self, ontology: GQAOntology, *, n_scenes: int, min_objects: int,
                 max_objects: int, object_num: int, n_nouns: int, n_attrs: int,
                 box_dim: int, noise: float, seed: int, device="cpu"):
        if not 1 <= min_objects <= max_objects <= object_num:
            raise ValueError(f"objects {min_objects}..{max_objects} do not fit {object_num} slots")
        rng = np.random.default_rng(seed)
        self.box_dim = box_dim
        self.object_num = object_num
        nouns = [t for t in ontology._nouns if t in ontology._arg_to_idx]
        self.nouns = [str(t) for t in rng.choice(nouns, n_nouns, replace=False)]
        n_cats = max(1, min(len(CATEGORY_PREFERENCE), n_attrs // 2))
        per_cat = [n_attrs // n_cats + (1 if i < n_attrs % n_cats else 0) for i in range(n_cats)]
        self.categories: List[Tuple[str, List[str]]] = []
        for name, k in zip(CATEGORY_PREFERENCE, per_cat):
            opts = [o for o in ontology.query(name) if o in ontology._arg_to_idx]
            self.categories.append((name, [str(o) for o in rng.choice(opts, min(k, len(opts)),
                                                                      replace=False)]))
        self.attrs = [o for _, opts in self.categories for o in opts]
        self._attr_of = {o: (ci, opts.index(o)) for ci, (_, opts) in enumerate(self.categories)
                         for o in opts}

        S, O = n_scenes, object_num
        self.n = rng.integers(min_objects, max_objects + 1, S)
        self.noun_ids = rng.integers(0, n_nouns, (S, O))
        self.cat_vals = np.stack([rng.integers(0, len(opts), (S, O))
                                  for _, opts in self.categories], axis=-1)
        self.x, self.y = rng.uniform(0, 600, (S, O)), rng.uniform(0, 440, (S, O))
        self.w, self.h = rng.uniform(5, 40, (S, O)), rng.uniform(5, 40, (S, O))
        self.objects = self._features(rng, S, O, box_dim, n_nouns, noise, device)
        self.mask = (np.arange(O)[None, :] < self.n[:, None]).astype(np.float32)
        self.objects *= self.mask[..., None]
        self.ids = [f"scene{i}" for i in range(S)]
        self._index = {im: i for i, im in enumerate(self.ids)}

    def _features(self, rng, S, O, box_dim, n_nouns, noise, device) -> np.ndarray:
        """(S, O, D+6) float32 on the host: each object's code (its noun's
        row plus one row per category value of a random codebook) plus
        noise, then [640, 480, x, y, w, h]; drawn on ``device`` from a
        generator seeded by ``rng`` (a few large calls)."""
        import torch

        gen = torch.Generator(device=device).manual_seed(int(rng.integers(2**62)))
        cats = [len(opts) for _, opts in self.categories]
        codebook = torch.randn((n_nouns + sum(cats), box_dim), generator=gen, device=device)
        offs = np.cumsum([n_nouns] + cats)[:-1]
        rows = np.concatenate([self.noun_ids[..., None],
                               offs[None, None, :] + self.cat_vals], axis=-1)  # (S, O, 1+C)
        out = np.empty((S, O, box_dim + 6), np.float32)
        step = max(1, (1 << 24) // (O * box_dim))  # scenes per draw: ~64 MB of noise
        for s in range(0, S, step):
            idx = torch.as_tensor(rows[s:s + step], device=device)
            feats = codebook[idx].sum(dim=-2)
            feats += noise * torch.randn(feats.shape, generator=gen, device=device)
            out[s:s + step, :, :box_dim] = feats.cpu().numpy()
        out[..., box_dim:] = np.stack([np.full((S, O), 640.0), np.full((S, O), 480.0),
                                       self.x, self.y, self.w, self.h], axis=-1)
        return out

    # ---------------------------------------------------------- features

    def image(self, image_id: str) -> Tuple[np.ndarray, int]:
        i = self._index[image_id]
        return self.objects[i], int(self.n[i])

    def scene(self, image_id: str) -> Tuple[np.ndarray, np.ndarray]:
        """(objects (O, D+6), mask (O,)) of one scene, padded: views, no copy."""
        i = self._index[image_id]
        return self.objects[i], self.mask[i]

    # ------------------------------------------------------ ground truth

    def holds(self, s: int, token) -> np.ndarray:
        """(n,) whether each object of scene ``s`` holds ``token`` (a noun,
        an attribute value, ``not(...)`` of either, or ``_`` for any)."""
        n = int(self.n[s])
        neg = isinstance(token, str) and token.startswith("not(") and token.endswith(")")
        tok = token[4:-1] if neg else token
        if tok in ("_", "scene", None):
            out = np.ones(n, bool)
        elif tok in self.nouns:
            out = self.noun_ids[s, :n] == self.nouns.index(tok)
        elif tok in self._attr_of:
            ci, v = self._attr_of[tok]
            out = self.cat_vals[s, :n, ci] == v
        else:
            out = np.zeros(n, bool)
        return out != neg

    def relation(self, s: int, rel: str) -> np.ndarray:
        """(n, n): rel(subject i, object j) from the boxes' centres."""
        n = int(self.n[s])
        cx = self.x[s, :n] + self.w[s, :n] / 2
        if rel == "to the left of":
            return cx[:, None] < cx[None, :]
        if rel == "to the right of":
            return cx[:, None] > cx[None, :]
        return np.zeros((n, n), bool)

    def eval_branch(self, s: int, ops: Sequence[dict]) -> np.ndarray:
        """The boolean object set a select/filter/relate chain leaves."""
        n = int(self.n[s])
        cur = np.ones(n, bool)
        off_diag = ~np.eye(n, dtype=bool)
        for op in ops:
            if op["operator"] in ("select", "filter"):
                cur = cur & self.holds(s, op["arguments"][0])
            else:  # relate: the new side holds aux and relates to some member
                rel, is_subject, aux = op["arguments"]
                neg = rel.startswith("not(")
                m = self.relation(s, rel[4:-1] if neg else rel) != neg
                m = (m if is_subject else m.T) & off_diag
                cur = self.holds(s, aux) & (m & cur[None, :]).any(axis=1)
        return cur

    def unique_objects(self, s: int) -> np.ndarray:
        """Objects whose noun occurs once in the scene."""
        ids = self.noun_ids[s, :int(self.n[s])]
        counts = np.bincount(ids, minlength=len(self.nouns))
        return np.flatnonzero(counts[ids] == 1)

    # --------------------------------------------------------- questions

    def _pin(self, rng, s: int, obj: int, length: int, exclude: Optional[int] = None):
        noun = self.nouns[self.noun_ids[s, obj]]
        ops = [{"operator": "select", "arguments": [noun]}]
        pool = [ci for ci in range(len(self.categories)) if ci != exclude]
        for _ in range(length):
            if pool:
                ci = int(rng.choice(pool))
                val = self.categories[ci][1][self.cat_vals[s, obj, ci]]
            else:
                val = noun
            ops.append({"operator": "filter", "arguments": [str(val)]})
        return ops

    def _free(self, rng, length: int, relate_prob: float = 0.3):
        ops = [{"operator": "select", "arguments": [str(rng.choice(self.nouns))]}]
        for _ in range(length):
            if rng.uniform() < relate_prob:
                ops.append({"operator": "relate",
                            "arguments": [str(rng.choice(RELATIONS)), bool(rng.uniform() < 0.5),
                                          str(rng.choice(self.nouns))]})
            else:
                ops.append({"operator": "filter", "arguments": [str(rng.choice(self.attrs))]})
        return ops

    def _alternating(self, rng, length: int):
        """select, then filter and relate in turn (filter first)."""
        ops = [{"operator": "select", "arguments": [str(rng.choice(self.nouns))]}]
        for h in range(length):
            if h % 2:
                ops.append({"operator": "relate",
                            "arguments": [str(rng.choice(RELATIONS)), bool(rng.uniform() < 0.5),
                                          str(rng.choice(self.nouns))]})
            else:
                ops.append({"operator": "filter", "arguments": [str(rng.choice(self.attrs))]})
        return ops

    def question(self, rng, family: str, hops: int, scenes: Sequence[int],
                 want: Optional[str] = None) -> Optional[dict]:
        """One question of ``family`` with ``hops`` hops beyond select on a
        scene drawn from ``scenes``, with its exact answer; None where the
        draw is not well posed (or its binary answer is not ``want``), so
        that the caller draws again."""
        s = int(scenes[int(rng.integers(0, len(scenes)))])
        q = self._draw(rng, family, hops, s)
        if q is None or (want is not None and family != "end" and q[2] != want
                         and q[2] in ("yes", "no")):
            return None
        branches, last, ans = q
        return {"program": {"branches": branches, "last_op": last}, "answer": ans,
                "imageId": self.ids[s]}

    def _draw(self, rng, family: str, hops: int, s: int):
        yes_no = lambda ok: "yes" if ok else "no"  # noqa: E731
        if family in ("exist", "end"):
            ops = self._alternating(rng, hops)
            if family == "end":  # the branch's last op ends the program: a statement
                return ([ops[:-1]] if len(ops) > 1 else []), ops[-1], "yes"
            return [ops], {"operator": "exist", "arguments": []}, yes_no(
                self.eval_branch(s, ops).any())
        if family == "verify_attrs":
            ops = self._free(rng, hops)
            cur = self.eval_branch(s, ops)
            attrs = [str(a) for a in rng.choice(self.attrs, int(rng.integers(1, 3)),
                                                replace=False)]
            ok = cur.copy()
            for a in attrs:
                ok &= self.holds(s, a)
            return [ops], {"operator": "verify_attrs", "arguments": [attrs]}, yes_no(ok.any())
        if family == "verify_rel":
            ops = self._free(rng, max(0, hops - 1))
            rel = [str(rng.choice(RELATIONS)), bool(rng.uniform() < 0.5),
                   str(rng.choice(self.nouns))]
            probe = ops + [{"operator": "relate", "arguments": rel}]
            return [ops], {"operator": "verify_rel", "arguments": rel}, yes_no(
                self.eval_branch(s, probe).any())
        if family in ("query_attr", "choose_attr"):
            uniq = self.unique_objects(s)
            ci = int(rng.integers(0, len(self.categories)))
            name, opts = self.categories[ci]
            if not len(uniq) or len(opts) < 2:
                return None
            obj = int(rng.choice(uniq))
            ops = self._pin(rng, s, obj, hops, exclude=ci)
            val = opts[self.cat_vals[s, obj, ci]]
            if family == "query_attr":
                return [ops], {"operator": "query_attr", "arguments": [name]}, val
            other = str(rng.choice([o for o in opts if o != val]))
            pair = [val, other] if rng.uniform() < 0.5 else [other, val]
            return [ops], {"operator": "choose_attr", "arguments": [pair]}, val
        if family == "choose_rel":
            uniq = self.unique_objects(s)
            if len(uniq) < 2:
                return None
            a, b = (int(v) for v in rng.choice(uniq, 2, replace=False))
            ops = self._pin(rng, s, b, max(0, hops - 1))
            is_subject = bool(rng.uniform() < 0.5)
            subj, obj = (a, b) if is_subject else (b, a)
            truth = next((r for r in RELATIONS if self.relation(s, r)[subj, obj]), None)
            if truth is None:  # two boxes with one centre
                return None
            other = next(r for r in RELATIONS if r != truth)
            pair = [truth, other] if rng.uniform() < 0.5 else [other, truth]
            aux = self.nouns[self.noun_ids[s, a]]
            return [ops], {"operator": "choose_rel", "arguments": [pair, is_subject, aux]}, truth
        if family in ("and", "or"):
            b1, b2 = self._free(rng, hops), self._free(rng, hops)
            e1, e2 = self.eval_branch(s, b1).any(), self.eval_branch(s, b2).any()
            return [b1, b2], {"operator": family, "arguments": []}, yes_no(
                (e1 and e2) if family == "and" else (e1 or e2))
        if family in ("two_same", "two_different"):
            uniq = self.unique_objects(s)
            if len(uniq) < 2:
                return None
            o1, o2 = (int(v) for v in rng.choice(uniq, 2, replace=False))
            ci = int(rng.integers(0, len(self.categories)))
            same = self.cat_vals[s, o1, ci] == self.cat_vals[s, o2, ci]
            return ([self._pin(rng, s, o1, hops, ci), self._pin(rng, s, o2, hops, ci)],
                    {"operator": family, "arguments": [self.categories[ci][0]]},
                    yes_no(same if family == "two_same" else not same))
        if family in ("all_same", "all_different"):
            ops = self._free(rng, hops)
            members = np.flatnonzero(self.eval_branch(s, ops))
            if len(members) < 2:
                return None
            ci = int(rng.integers(0, len(self.categories)))
            vals = self.cat_vals[s, members, ci]
            same = bool((vals == vals[0]).all())
            return [ops], {"operator": family, "arguments": [self.categories[ci][0]]}, yes_no(
                same if family == "all_same" else not same)
        if family == "compare":
            uniq = self.unique_objects(s)
            if len(uniq) < 2:
                return None
            o1, o2 = (int(v) for v in rng.choice(uniq, 2, replace=False))
            ci = int(rng.integers(0, len(self.categories)))
            opts = self.categories[ci][1]
            v1, v2 = self.cat_vals[s, o1, ci], self.cat_vals[s, o2, ci]
            if v1 == v2:
                return None
            is_less = bool(rng.uniform() < 0.5)
            winner = o2 if is_less else o1
            return ([self._pin(rng, s, o1, hops, ci), self._pin(rng, s, o2, hops, ci)],
                    {"operator": "compare", "arguments": [str(opts[v1]), is_less]},
                    self.nouns[self.noun_ids[s, winner]])
        raise ValueError(f"unknown question family {family!r}")

    def questions(self, rng, family: str, hops: int, n: int, scenes: Sequence[int],
                  balanced: bool = True, prefix: str = "q") -> List[dict]:
        """``n`` questions of one family on ``scenes``; ``balanced``
        alternates the binary answers."""
        out: List[dict] = []
        want = "yes"
        for _ in range(n * 500):
            if len(out) == n:
                return out
            q = self.question(rng, family, hops, scenes, want if balanced else None)
            if q is None:
                continue
            if q["answer"] in ("yes", "no") and family != "end":
                want = "no" if want == "yes" else "yes"
            q["question_id"] = f"{prefix}{len(out)}"
            out.append(q)
        raise RuntimeError(f"only {len(out)}/{n} {family} questions on {len(scenes)} scenes")
