"""The reference against the port on the CPU at tiny widths, on every path the
cells drive: the thirteen servable terminals and statements with and
without the calibrator, the shared-image route of the offline files, and
training steps at dropout 0 and at the published 0.1 (the masks drawn from
one seeded generator in the same order)."""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import weights  # noqa: E402
from benchmark.reference import check  # noqa: E402
from benchmark.reference.config import Config as RefConfig  # noqa: E402
from benchmark.reference.features import Scenes  # noqa: E402
from benchmark.reference.interpreter import Interpreter as RefInterpreter  # noqa: E402
from benchmark.reference.ontology import GQAOntology as RefOntology  # noqa: E402
from benchmark.reference.program_compiler import ProgramCompiler as RefCompiler  # noqa: E402
from benchmark.reference.program_compiler import batch_arrays as ref_batch_arrays  # noqa: E402
from benchmark.tests.tiny import TINY_WORLD, tiny_config  # noqa: E402
from benchmark.traffic import mix  # noqa: E402
from benchmark.traffic.world import FAMILIES  # noqa: E402

from dfol_vqa_tpu_torch.compiler.program_compiler import ProgramCompiler, batch_arrays  # noqa: E402
from dfol_vqa_tpu_torch.config import Config  # noqa: E402
from dfol_vqa_tpu_torch.models.interpreter import Interpreter  # noqa: E402
from dfol_vqa_tpu_torch.ontology import GQAOntology  # noqa: E402

ONT, REF_ONT = GQAOntology(), RefOntology()


def _sides(tmp_path, cell, seed=11, **overrides):
    """(port cfg, interpreter, params), (reference cfg, interpreter,
    params), with the same weights drawn from ``seed``."""
    path = tiny_config(tmp_path, cell)
    cfg, rcfg = Config.from_yaml(path), RefConfig.from_yaml(path)
    for c in (cfg, rcfg):
        for k, v in overrides.items():
            if hasattr(c.tpu, k):
                setattr(c.tpu, k, v)
            else:
                setattr(c, k, v)
    interp, rinterp = Interpreter(cfg, ONT), RefInterpreter(rcfg, REF_ONT)
    params = interp.init_params(torch.Generator().manual_seed(0))
    values = weights.draw(params, seed, "cpu")
    rparams = rinterp.init_params(torch.Generator().manual_seed(0))
    weights.copy_into(rparams, values)
    return (cfg, interp, params), (rcfg, rinterp, rparams)


def _world(seed=5, **kw):
    spec = {"world": dict(TINY_WORLD, **kw)}
    return mix.make_world(REF_ONT, spec, 8, 32, seed)


def _tensors(arrays, objects, mask, img_index=None):
    out = {k: torch.as_tensor(np.asarray(v)) for k, v in arrays.items()
           if isinstance(v, np.ndarray)}
    if img_index is not None:
        out["img_index"] = torch.as_tensor(img_index)
    return torch.as_tensor(objects), torch.as_tensor(mask), out


@pytest.mark.parametrize("cell", ["cur7-serve-rel", "cur5-train-shuffled"])
@pytest.mark.parametrize("family", FAMILIES)
def test_forward_matches_the_port(tmp_path, cell, family):
    (cfg, interp, params), (rcfg, rinterp, rparams) = _sides(tmp_path, cell)
    world = _world()
    rng = np.random.default_rng(3)
    qs = world.questions(rng, family, 2 if family not in ("two_same", "two_different",
                                                          "compare") else 1, 6,
                         np.arange(len(world.ids)), balanced=False)
    for q in qs:
        spec, cb = ProgramCompiler(ONT, object_num=8, rel_slots=8).compile([q])
        rspec, rcb = RefCompiler(REF_ONT, object_num=8, rel_slots=8).compile([q])
        objects, mask = Scenes(world).batch([q["imageId"]], 8)
        with torch.no_grad():
            got = interp.forward(params, *_tensors(batch_arrays(cb), objects, mask), spec)
            want = rinterp.forward(rparams, *_tensors(ref_batch_arrays(rcb), objects, mask),
                                   rspec)
        np.testing.assert_allclose(got["log_probability"].numpy(),
                                   want["log_probability"].numpy(), rtol=1e-6, atol=1e-6)


def test_shared_route_matches_the_port(tmp_path):
    """An offline batch on shared scenes (U * 2 <= B), float32 stream on both
    sides (the bf16 storage of h2 is the card's kernel route's)."""
    (cfg, interp, params), _ = _sides(tmp_path, "cur7-eval-file")
    world = _world()
    files = mix.eval_files(world, {"batch": 16, "images_per_batch": 4,
                                   "mix": [["exist", 2, 16], ["verify_rel", 2, 16],
                                           ["query_attr", 1, 16]]}, seed=2)
    path = tiny_config(tmp_path, "cur7-eval-file")
    ref = check.Reference(path, dict(params.named_parameters()), "cpu")
    compiler = ProgramCompiler(ONT, object_num=8, rel_slots=8)
    for qs in files:
        spec, cb = compiler.compile(qs)
        objects, mask, img = Scenes(world).batch_unique(cb.image_ids, 8)
        assert len(set(cb.image_ids)) * 2 <= len(qs)
        with torch.no_grad():
            got = interp.forward(params, *_tensors(batch_arrays(cb), objects, mask, img), spec)
        lp = got["log_probability"].double().numpy()
        for qi, scores in enumerate(ref.option_scores(qs, world, shared=True)):
            if lp.ndim == 2:
                want = [scores[o] for o in cb.option_strings[qi]]
                np.testing.assert_allclose(lp[qi, :len(want)], want, rtol=1e-6, atol=1e-6)
            else:
                assert lp[qi] == pytest.approx(scores["yes"], rel=1e-6, abs=1e-6)


def test_stored_stream_rounds_the_pair_code(tmp_path):
    """At inference with a bfloat16 stream the reference's shared route
    reads h2 rounded to bfloat16, which moves the scores (so the CPU test
    above sets the stream to float32)."""
    world = _world()
    files = mix.eval_files(world, {"batch": 16, "images_per_batch": 4,
                                   "mix": [["verify_rel", 2, 16]]}, seed=2)
    path = tiny_config(tmp_path, "cur7-eval-file")
    (cfg, interp, params), _ = _sides(tmp_path, "cur7-eval-file")
    ref = check.Reference(path, dict(params.named_parameters()), "cpu")
    ref.cfg.tpu.rel_stream_dtype = "bfloat16"
    stored = ref.option_scores(files[0], world, shared=True)
    ref.cfg.tpu.rel_stream_dtype = "float32"
    plain = ref.option_scores(files[0], world, shared=True)
    diffs = [abs(a["yes"] - b["yes"]) for a, b in zip(stored, plain)]
    assert 0 < max(diffs) < 1e-1


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_training_steps_match_the_port(tmp_path, dropout):
    """Three steps of the port's trainer step (``compute_grads``, then its
    optimizer) against ``Reference.train_steps``: losses, the first
    gradient as Adam holds it, and the parameters after the three."""
    from dfol_vqa_tpu_torch.data.loader import LoadedBatch
    from dfol_vqa_tpu_torch.train.optim import build_optimizer
    from dfol_vqa_tpu_torch.train.trainer import VQATrainer

    (cfg, interp, params), _ = _sides(tmp_path, "cur5-train-shuffled", dropout=dropout)
    path = tiny_config(tmp_path, "cur5-train-shuffled")
    import yaml
    d = yaml.safe_load(open(path))
    d["dropout"] = dropout
    yaml.safe_dump(d, open(path, "w"))
    initial = {k: v.detach().clone() for k, v in params.named_parameters()}
    world = _world(scenes=40)
    files = mix.train_files(world, {"mix": [["exist", 2, 16], ["verify_rel", 1, 16],
                                            ["query_attr", 1, 16]]}, seed=4)
    trainer = VQATrainer(cfg, interp, device="cpu")
    opt = build_optimizer(cfg, params)
    opt.static_grads()
    gen = torch.Generator().manual_seed(77)
    compiler = ProgramCompiler(ONT, object_num=8, rel_slots=8)
    losses, grad1 = [], None
    for qs in files:
        spec, cb = compiler.compile(qs)
        objects, mask, img = Scenes(world).batch_unique(cb.image_ids, 8)
        losses.append(float(trainer.compute_grads(params, LoadedBatch(spec, cb, objects, mask,
                                                                       img), gen)))
        opt.step()
        if grad1 is None:
            names = {id(p): n for n, p in params.named_parameters()}
            grad1 = {names[id(p)]: opt.adam.state[p]["exp_avg"] / 0.1 for p in opt.trainable}
    ref = check.Reference(path, initial, "cpu")
    rlosses, rgrad1, rfinal = ref.train_steps(files, world, 77)
    np.testing.assert_allclose(losses, rlosses, rtol=1e-6)
    keep = check.moving_leaves(rgrad1)
    assert check.leaf_gaps(grad1, rgrad1, keep)[0] < 1e-6
    final = {k: v.detach() for k, v in params.named_parameters()}
    assert check.leaf_gaps({k: final[k] - initial[k] for k in keep},
                           {k: rfinal[k] - initial[k] for k in keep}, keep)[0] < 1e-6


def test_answer_gap():
    scores = {"yes": -0.1, "no": -2.4}
    assert check.answer_gap(["yes"], scores) == 0.0
    assert check.answer_gap(["no"], scores) == pytest.approx(2.3)
    assert check.answer_gap([], scores) == float("inf")
    assert check.answer_gap(["red"], {"red": -1.0, "blue": -0.5}) == pytest.approx(0.5)
