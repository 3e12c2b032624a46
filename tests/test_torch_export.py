"""The weight-free serving artifact (``export.py``) and kernel 1 as a
registered operator, on the CPU at tiny widths.

Ports the cases of ``tests/test_export.py`` and of the deployment rehearsal
``tests/test_serve_deployment.py``:

* the spec/meta JSON round trip;
* an exported set serves without tracing: ``Interpreter.forward`` raises on
  the loading engine, its answers equal the live engine's, it makes no live
  step (``compiled_steps == 0``, ``trace_steps == 0``, ``aot_steps > 0``),
  and ``trace`` is served from the artifact too;
* an artifact that does not fit the engine is rejected: object count,
  transfer dtype, a batch rung the engine can reach, the device type; and
  an unknown format;
* weight-free: no module holds a parameter, and an artifact exported with
  seed-0 weights serves seed-1 weights with seed-1's live answers;
* train -> npz checkpoint -> export -> serve over HTTP with
  ``Interpreter.forward`` forbidden: the online accuracy equals the
  trainer's offline accuracy;
* the operator ``dfol_vqa_tpu_torch::relation_oracle_fwd``:
  ``torch.library.opcheck`` on CPU tensors, and ``torch.export`` of the
  per-question relation route records it as one node that a reloaded
  program runs (the card's artifact holds the same node; a CPU engine
  takes the plain route, so its steps hold none).

Two rungs and a few specs keep the export count small.
"""

import json
import os
import urllib.request

import numpy as np
import pytest
import torch

from dfol_vqa_tpu_torch import serve
from dfol_vqa_tpu_torch.compiler.program_compiler import ProgramCompiler
from dfol_vqa_tpu_torch.data.dataset import ProgramDataset
from dfol_vqa_tpu_torch.data.loader import BatchLoader, LoadedBatch
from dfol_vqa_tpu_torch.export import (
    export_serving_set,
    load_serving_set,
    meta_from_json,
    meta_to_json,
    spec_from_json,
    spec_to_json,
)
from dfol_vqa_tpu_torch.http_frontend import ServingHTTPFrontend
from dfol_vqa_tpu_torch.models.interpreter import Interpreter
from dfol_vqa_tpu_torch.ops import relation_oracle as ro
from dfol_vqa_tpu_torch.train import checkpoint
from dfol_vqa_tpu_torch.train.optim import build_optimizer
from dfol_vqa_tpu_torch.train.trainer import VQATrainer

LADDER = (1, 2)
O = 8  # the tiny demo's objects


def engine(seed=0, **kw):
    """A tiny demo engine on the CPU with the two-rung ladder."""
    kw = {"max_batch": 2, "batch_ladder": LADDER, "max_delay_ms": 5.0, **kw}
    return serve.build_demo_engine(tiny=True, seed=seed, device="cpu", **kw)


def sample(world):
    qs = []
    for fam, hops in (("exist", 0), ("exist", 2), ("verify_rel", 1), ("query_attr", 1)):
        qs += world.generate_family(fam, 3, length=hops, seed=11, neg_prob=0.3 * (fam == "exist"),
                                    id_prefix=f"x{fam}{hops}-")
    return qs


def forbid_forward(monkeypatch):
    monkeypatch.setattr(Interpreter, "forward", lambda *a, **k: (_ for _ in ()).throw(
        AssertionError("Interpreter.forward called on the serving host")))


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """The seed-0 demo engine's set for ``sample`` with traces; returns
    (world, questions, artifact dir, manifest)."""
    _, _, world, eng = engine(start=False)
    qs = sample(world)
    out = str(tmp_path_factory.mktemp("art") / "set")
    manifest = export_serving_set(eng, qs, out, include_traces=True)
    eng.stop()
    return world, qs, out, manifest


def live_answers(qs, seed=0):
    _, _, _, live = engine(seed)
    try:
        return [r.answers for r in live.answer_many(qs)], live.trace(qs[-1])
    finally:
        live.stop()


def test_spec_meta_json_roundtrip(artifact):
    world, qs, *_ = artifact
    _, _, _, eng = engine(start=False)
    compiler = ProgramCompiler(eng.interp.ont, object_num=O, rel_slots=eng.cfg.tpu.rel_table_size)
    spec, cb = compiler.compile(qs[:2])
    objs, mask = world.batch([q["imageId"] for q in qs[:2]], O)
    lb = LoadedBatch(spec, cb, objs, mask)
    spec2 = spec_from_json(json.loads(json.dumps(spec_to_json(spec))))
    meta2 = meta_from_json(json.loads(json.dumps(meta_to_json(lb.meta))))
    assert spec2 == spec and hash(spec2) == hash(spec)
    assert meta2 == lb.meta
    eng.stop()


def test_exported_set_serves_without_tracing(artifact, monkeypatch):
    world, qs, out, manifest = artifact
    assert manifest["n_specs"] >= 4 and manifest["device_type"] == "cpu"
    # two eval rungs + one trace module per spec
    assert len(manifest["executables"]) == manifest["n_specs"] * 3
    assert manifest["batch_sizes"] == list(LADDER) and manifest["artifact_mb"] > 0
    assert manifest["torch_version"] == torch.__version__
    want, want_trace = live_answers(qs)
    loaded = load_serving_set(out)
    forbid_forward(monkeypatch)
    _, _, _, eng = engine(executables=loaded)
    try:
        got = [r.answers for r in eng.answer_many(qs)]
        tr = eng.trace(qs[-1])
    finally:
        eng.stop()
    assert got == want
    assert tr["answers"] == want[-1] and tr["hops"]
    assert [(h["op"], h["token"]) for h in tr["hops"]] == [
        (h["op"], h["token"]) for h in want_trace["hops"]]
    for h, w in zip(tr["hops"], want_trace["hops"]):
        np.testing.assert_array_equal(h["attention"], w["attention"])
    assert eng.stats["compiled_steps"] == 0
    assert eng.stats["trace_steps"] == 0
    assert eng.stats["aot_steps"] > 0


def test_artifact_engine_mismatch_rejected(artifact, tmp_path):
    _, _, out, _ = artifact
    _, _, _, same = engine(start=False)
    assert load_serving_set(out, engine=same)
    _, _, _, wide = engine(start=False)
    wide.cfg.tpu.max_object_num = O + 4  # the engine would never hit the keys
    with pytest.raises(ValueError, match="object_num"):
        load_serving_set(out, engine=wide)
    _, _, _, bf16 = engine(start=False)
    bf16.transfer_dtype = "bfloat16"
    with pytest.raises(ValueError, match="transfer_dtype"):
        load_serving_set(out, engine=bf16)
    _, _, _, taller = engine(max_batch=4, batch_ladder=(1, 2, 4), start=False)
    with pytest.raises(ValueError, match="batch rungs"):
        load_serving_set(out, engine=taller)
    # a program recorded on another device type is never served
    moved = tmp_path / "moved"
    moved.mkdir()
    manifest = json.loads(open(os.path.join(out, "manifest.json")).read())
    manifest["device_type"] = "cuda"
    (moved / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="device_type"):
        load_serving_set(str(moved), engine=same)
    for e in (same, wide, bf16, taller):
        e.stop()


def test_artifact_format_guard(tmp_path):
    os.makedirs(tmp_path / "bad", exist_ok=True)
    with open(tmp_path / "bad" / "manifest.json", "w") as f:
        json.dump({"format": "dfol_vqa_tpu.serving_set.v1"}, f)  # the JAX package's
    with pytest.raises(ValueError, match="format"):
        load_serving_set(str(tmp_path / "bad"))


def test_artifact_is_weight_free(artifact, monkeypatch):
    world, qs, out, _ = artifact
    loaded = load_serving_set(out)
    for stored in loaded.values():
        ep = stored.load()
        assert not ep.state_dict
        assert sum(c.numel() for c in ep.constants.values()) <= 16
    # no module file holds the bytes of any weight it was exported with
    _, _, _, seed0 = engine(seed=0, start=False)
    heads = [p.detach().numpy().tobytes()[:64] for p in seed0.params.parameters()]
    seed0.stop()
    for name in os.listdir(out):
        if name.endswith(".pt2"):
            blob = open(os.path.join(out, name), "rb").read()
            assert not any(h in blob for h in heads), name
    want0, _ = live_answers(qs, seed=0)
    want1, _ = live_answers(qs, seed=1)
    assert want0 != want1  # the weights decide answers here
    forbid_forward(monkeypatch)
    _, _, _, eng = engine(seed=1, executables=loaded)
    try:
        got = [r.answers for r in eng.answer_many(qs)]
    finally:
        eng.stop()
    assert got == want1
    assert eng.stats["compiled_steps"] == 0


def test_train_checkpoint_export_serve(ontology, tmp_path, monkeypatch):
    cfg, ont, world, eng = engine(start=False)
    eng.stop()
    params = eng.params
    train_qs = world.generate(192, hops=1, seed=1)
    test_qs = world.generate(32, hops=1, seed=2)
    compiler = ProgramCompiler(ont, object_num=O, rel_slots=2)

    def loader(qs, shuffle):
        return BatchLoader([ProgramDataset(qs, ont)], compiler, world, 32, O, shuffle=shuffle)

    trainer = VQATrainer(cfg, eng.interp, device="cpu")
    opt = build_optimizer(cfg, params)
    for _ in range(4):
        for batch in loader(train_qs, True):
            trainer.train_step(params, opt, batch)
    offline_acc = 1.0 - float(trainer.test_epoch(loader(test_qs, False), params)[0])

    # the serving host starts from fresh weights and restores the checkpoint
    checkpoint.save(str(tmp_path), "best", params, global_step=24)
    _, _, _, fresh = engine(seed=99, start=False)
    restored, step = checkpoint.load(str(tmp_path), "best", fresh.params)
    fresh.stop()
    assert step == 24
    _, _, _, exporter = engine(params=restored, start=False)
    export_serving_set(exporter, test_qs, str(tmp_path / "art"))
    loaded = load_serving_set(str(tmp_path / "art"), engine=exporter)
    exporter.stop()

    forbid_forward(monkeypatch)
    _, _, _, host = engine(params=restored, executables=loaded)
    front = ServingHTTPFrontend(host, port=0)
    try:
        req = urllib.request.Request(f"http://{front.host}:{front.port}/v1/answers",
                                     data=json.dumps({"questions": test_qs}).encode())
        with urllib.request.urlopen(req, timeout=600) as r:
            out = json.loads(r.read())
    finally:
        front.close()
        host.stop()
    served = [res["answers"] for res in out["results"]]
    online_acc = float(np.mean([q["answer"] in a for q, a in zip(test_qs, served)]))
    assert online_acc == pytest.approx(offline_acc, abs=1e-9)
    assert host.stats["compiled_steps"] == 0 and host.stats["aot_steps"] > 0


def pair_tail_case(seed=0, B=2, O=5, H=6, E=7, R=3):
    g = torch.Generator().manual_seed(seed)
    ins = [torch.randn((B, O, H), generator=g), torch.randn((B, O, H), generator=g),
           torch.rand((B, O, O, 4), generator=g), torch.randn((4, H), generator=g),
           torch.randn((H,), generator=g), torch.randn((H, E), generator=g),
           torch.randn((E,), generator=g), torch.randn((B, R, E), generator=g),
           torch.randn((B, R), generator=g)]
    tok = torch.tensor([[1, 2, 0], [3, 0, 0]], dtype=torch.int32)[:B, :R]
    return ins, tok


def test_operator_opcheck_cpu():
    ins, tok = pair_tail_case()
    torch.library.opcheck(torch.ops.dfol_vqa_tpu_torch.relation_oracle_fwd.default,
                          (*ins, tok, -30.0))
    got = ro.relation_oracle_fwd(*ins, tok, -30.0)
    assert torch.equal(got, ro.pair_tail_reference(*ins, tok))
    assert ro.LAUNCHES == 0  # CPU tensors never reach the CUDA kernel


class _RelRoute(torch.nn.Module):
    def forward(self, h_s, h_o, geom, w_g, b0, w2, b2, e_sel, b_sel, tok):
        return ro.PairTail.apply(h_s, h_o, geom, w_g, b0, w2, b2, e_sel, b_sel, tok, -30.0)


def test_operator_is_one_node_of_an_exported_program(tmp_path):
    ins, tok = pair_tail_case(1)
    with torch.no_grad():
        ep = torch.export.export(_RelRoute(), (*ins, tok), strict=False)
    nodes = [n for n in ep.graph.nodes
             if n.op == "call_function" and "relation_oracle_fwd" in str(n.target)]
    assert len(nodes) == 1
    torch.export.save(ep, str(tmp_path / "route.pt2"))
    again = torch.export.load(str(tmp_path / "route.pt2"))
    assert torch.equal(again.module()(*ins, tok), ro.pair_tail_reference(*ins, tok))


def test_calibrator_artifact_takes_the_embedding_as_an_input(tmp_path, monkeypatch):
    """With the calibrator, the (V+1, D) GloVe matrix it reads is a step
    input like the weights: no module holds it as a constant, and the
    artifact serves the live engine's answers."""
    from tests.test_torch_calibrator import calib_cfg

    cfg = calib_cfg()
    cfg.tpu.max_object_num = O
    _, ont, world, _ = engine(start=False)
    params = Interpreter(cfg, ont).init_params(torch.Generator().manual_seed(2))
    kw = dict(features=world, device="cpu", max_batch=2, batch_ladder=LADDER)
    qs = world.generate_family("exist", 2, length=1, seed=3)
    live = serve.ServingEngine(cfg, ont, params, **kw)
    try:
        export_serving_set(live, qs, str(tmp_path / "art"), include_traces=True)
        want = [r.answers for r in live.answer_many(qs)]
        want_trace = live.trace(qs[0])
    finally:
        live.stop()
    loaded = load_serving_set(str(tmp_path / "art"), engine=live)
    emb = live.interp.embedding_matrix
    for stored in loaded.values():
        ep = stored.load()
        assert not ep.state_dict
        assert sum(c.numel() for c in ep.constants.values()) < emb.size
    forbid_forward(monkeypatch)
    eng = serve.ServingEngine(cfg, ont, params, executables=loaded, **kw)
    try:
        assert [r.answers for r in eng.answer_many(qs)] == want
        assert eng.trace(qs[0]) == want_trace
    finally:
        eng.stop()
    assert eng.stats["compiled_steps"] == 0
