"""The port's HTTP frontend (``http_frontend.py``), on the CPU at tiny widths.

Ports the cases of ``tests/test_http_frontend.py`` over real sockets:
``/healthz`` (the engine's device) and ``/stats``; concurrent clients whose
answers equal the engine's one request at a time and who share batches;
the bulk endpoint with and without inline features; ``/v1/trace`` equal
to ``ServingEngine.trace``; 400 for bad requests and 404 for unknown
paths; 429 with ``retryable`` when the engine is at ``max_pending``; and
the daemon itself, ``python -m dfol_vqa_tpu_torch.http_frontend --cpu
--tiny --port 0 --artifact DIR --warmup``, started in a subprocess,
answering from the artifact over HTTP and stopped with SIGINT.
"""

import json
import os
import re
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import pytest

from dfol_vqa_tpu_torch import serve
from dfol_vqa_tpu_torch.export import export_serving_set
from dfol_vqa_tpu_torch.http_frontend import ServingHTTPFrontend

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
O = 8


@pytest.fixture(scope="module")
def served():
    _, _, world, eng = serve.build_demo_engine(tiny=True, seed=0, max_batch=8,
                                               max_delay_ms=20.0, device="cpu")
    _, _, _, direct = serve.build_demo_engine(tiny=True, seed=0, max_batch=1, device="cpu")
    front = ServingHTTPFrontend(eng, port=0)
    yield world, direct, front
    front.close()
    eng.stop()
    direct.stop()


def direct_answers(direct, qs):
    """The engine's answers one request at a time (batch rung 1)."""
    return [direct.answer_many([q])[0].answers for q in qs]


def _post(host, port, path, payload):
    req = urllib.request.Request(f"http://{host}:{port}{path}", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def _get(host, port, path):
    with urllib.request.urlopen(f"http://{host}:{port}{path}", timeout=60) as r:
        return json.loads(r.read())


def test_healthz_and_stats(served):
    *_, front = served
    assert _get(front.host, front.port, "/healthz") == {"ok": True, "device": "cpu",
                                                        "device_name": "cpu"}
    s = _get(front.host, front.port, "/stats")
    assert {"requests", "batches", "latency", "pending", "compiled_steps", "aot_steps",
            "trace_steps"} <= set(s)


def test_concurrent_requests_match_direct_and_share_batches(served):
    world, direct, front = served
    # repeated families, so concurrent sockets make same-spec requests
    qs = (world.generate_family("exist", 8, length=1, seed=13)
          + world.generate_family("query_attr", 4, length=1, seed=14))
    want = direct_answers(direct, qs)
    eng = front.engine
    batches_before = eng.stats["batches"]
    results = [None] * len(qs)

    def client(i):
        results[i] = _post(front.host, front.port, "/v1/answer", {"question": qs[i]})

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(qs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        assert not t.is_alive()
    assert [r["answers"] for r in results] == want
    # fewer dispatches than requests: requests from different sockets shared batches
    assert eng.stats["batches"] - batches_before < len(qs)
    assert any(r["batch_size"] > 1 for r in results)


def test_bulk_endpoint_and_inline_features(served):
    world, direct, front = served
    qs = world.generate_family("exist", 3, length=1, seed=4)
    want = direct_answers(direct, qs)
    out = _post(front.host, front.port, "/v1/answers", {"questions": qs})
    assert [r["answers"] for r in out["results"]] == want
    # inline features bypass the engine's FeatureSource
    objs, mask = world.batch([q["imageId"] for q in qs], O)
    out2 = _post(front.host, front.port, "/v1/answers",
                 {"questions": qs, "objects": objs.tolist(), "obj_mask": mask.tolist()})
    assert [r["answers"] for r in out2["results"]] == want


def test_trace_endpoint(served):
    world, direct, front = served
    q = world.generate_family("verify_rel", 1, length=1, seed=6)[0]
    out = _post(front.host, front.port, "/v1/trace", {"question": q})
    assert out["answers"] == direct_answers(direct, [q])[0]
    assert out["hops"] and all("attention" in h for h in out["hops"])
    assert out == json.loads(json.dumps(front.engine.trace(q)))


@pytest.mark.parametrize(
    "path,payload,code",
    [
        ("/v1/answer", {"no_question": 1}, 400),  # missing key
        ("/v1/answer", {"question": {"program": {"branches": [], "last_op":
            {"operator": "scene", "arguments": []}}, "imageId": "x"}}, 400),
        ("/v1/nope", {}, 404),
        ("/v1/answers", {"questions": [{"program": {"branches": [],
            "last_op": {"operator": "exist", "arguments": []}}, "imageId": "x"}],
            "objects": [], "obj_mask": []}, 400),  # length mismatch
        ("/v1/trace", {"question": {"program": {"branches": [], "last_op":
            {"operator": "object_attr", "arguments": []}}, "imageId": "x"}}, 400),
    ],
)
def test_error_paths(served, path, payload, code):
    *_, front = served
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(front.host, front.port, path, payload)
    assert ei.value.code == code
    assert "error" in json.loads(ei.value.read())


def test_bad_json_and_unknown_get(served):
    *_, front = served
    req = urllib.request.Request(f"http://{front.host}:{front.port}/v1/answer", data=b"{nope")
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=60)
    assert ei.value.code == 400 and "bad JSON" in json.loads(ei.value.read())["error"]
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(front.host, front.port, "/nope")
    assert ei.value.code == 404


def test_overload_maps_to_429():
    # start=False and a long delay: queued requests never drain, so the bound trips
    _, _, world, eng = serve.build_demo_engine(tiny=True, seed=0, max_batch=8, device="cpu",
                                               max_delay_ms=1e6, max_pending=1, start=False)
    front = ServingHTTPFrontend(eng, port=0)
    try:
        q = world.generate_family("exist", 1, length=0, seed=2)[0]
        eng.submit(q)  # fills the queue; nothing will drain it
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(front.host, front.port, "/v1/answer", {"question": q})
        assert ei.value.code == 429
        body = json.loads(ei.value.read())
        assert body["retryable"] is True
        assert "max_pending" in body["error"]
    finally:
        front.close()
        eng.stop()


def test_daemon_serves_an_artifact(tmp_path):
    _, _, world, eng = serve.build_demo_engine(tiny=True, seed=0, max_batch=2, device="cpu",
                                               start=False)
    q = world.generate_family("verify_rel", 1, length=1, seed=6)[0]
    export_serving_set(eng, [q], str(tmp_path / "art"), include_traces=True)
    eng.stop()
    _, _, _, live = serve.build_demo_engine(tiny=True, seed=0, max_batch=2, device="cpu")
    want = live.answer_many([q])[0].answers
    want_trace = live.trace(q)
    live.stop()
    proc = subprocess.Popen(
        [sys.executable, "-m", "dfol_vqa_tpu_torch.http_frontend", "--cpu", "--tiny",
         "--port", "0", "--max-batch", "2", "--artifact", str(tmp_path / "art"), "--warmup"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONPATH": ROOT})
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            m = re.search(r"listening on http://([\d.]+):(\d+)", line)
            if m:
                break
        else:
            raise AssertionError("daemon exited before listening:\n" + "".join(lines))
        host, port = m.group(1), int(m.group(2))
        assert "loaded 3 exported steps" in "".join(lines)
        assert "read 3 modules" in "".join(lines)
        assert _post(host, port, "/v1/answer", {"question": q})["answers"] == want
        assert _post(host, port, "/v1/trace", {"question": q}) == json.loads(
            json.dumps(want_trace))
        stats = _get(host, port, "/stats")
        # --warmup read every module before listening
        assert stats["aot_steps"] == 3 and stats["compiled_steps"] == 0
        assert stats["trace_steps"] == 0
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.stdout.close()
    assert proc.returncode == 0
