"""Hop-by-hop reasoning visualization and trace export.

Port of ``dfol_vqa_tpu/viz.py``. The executor's ``return_trace`` path
(``Interpreter.forward``) gives every live slot's (B, O) attention;
``trace_to_dict`` turns it into one JSON entry per question (ops, tokens
and the object attentions per hop, the log-probability), ``render_question``
draws per-hop attention boxes over the image (matplotlib, imported only
there), and ``visualize_loop`` is the visualization epoch: ``traces.json``
always, image overlays when the images directory exists.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from dfol_vqa_tpu_torch.data.transfer import to_device_batch

_OP_NAMES = {1: "select", 2: "filter", 3: "relate"}


def trace_to_dict(batch, out, trace) -> list:
    """Per-question execution trace: ops, args and attention per hop.
    ``out["log_probability"]`` and ``trace`` (per branch, the per-slot
    (B, O) log-attentions) may be tensors or numpy arrays."""
    cb = batch.compiled
    spec = batch.spec
    lp = np.asarray(_host(out["log_probability"]))
    result = []
    for qi in range(len(cb.image_ids)):
        if cb.question_mask[qi] == 0:
            continue
        hops = []
        for b, grid in enumerate(spec.grid):
            live = [si for si, opc in enumerate(grid) if opc != 0]
            for tr_i, si in enumerate(live):
                if cb.op_mask[qi, b, si] == 0:
                    continue
                hops.append({
                    "branch": b,
                    "op": _OP_NAMES[grid[si]],
                    "token": int(cb.arg_tok[qi, b, si]),
                    "attention": np.exp(np.asarray(_host(trace[b][tr_i]))[qi]).tolist(),
                })
        result.append({
            "question_id": cb.question_ids[qi],
            "image_id": cb.image_ids[qi],
            "terminal_op": spec.terminal_op,
            "answer": cb.answers[qi],
            "log_probability": lp[qi].tolist(),
            "hops": hops,
        })
    return result


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def render_question(image_path, image_id, bboxes, attentions, ops, out_file,
                    show: bool = False):
    """Overlay per-hop attention boxes on the image and write ``out_file``;
    with ``show=True`` (and a display) also open a window per question."""
    import matplotlib

    if not show:
        matplotlib.use("Agg")
    import matplotlib.patches as patches
    import matplotlib.pyplot as plt

    img_file = os.path.join(image_path, f"{image_id}.jpg")
    n = len(attentions)
    fig, axes = plt.subplots(1, max(n, 1), figsize=(6 * max(n, 1), 6))
    if n <= 1:
        axes = [axes]
    img = plt.imread(img_file) if os.path.exists(img_file) else None
    for h, (att, op_label) in enumerate(zip(attentions, ops)):
        ax = axes[h]
        if img is not None:
            ax.imshow(img)
        for o, a in enumerate(att):
            if o >= len(bboxes):
                break
            x, y, w, hgt = bboxes[o]
            ax.add_patch(patches.Rectangle((x, y), w, hgt, linewidth=1 + 3 * a,
                                           edgecolor=(0, 1, 0, min(1.0, 0.15 + a)),
                                           facecolor="none"))
        ax.set_title(op_label)
        ax.axis("off")
    fig.savefig(out_file, bbox_inches="tight")
    if show:
        plt.show()  # blocks until the window closes
    plt.close(fig)


def visualize_loop(trainer, interp, loader, params, image_path: Optional[str],
                   import_path: Optional[str], out_dir: str = "visualizations",
                   show: bool = False):
    """The visualization epoch on ``trainer.device``: every batch of
    ``loader`` through ``interp.forward(return_trace=True)``, its entries
    written to ``out_dir/traces.json``, and per-question overlays when
    ``image_path`` is a directory. ``import_path`` loads a checkpoint
    first. Returns the entries."""
    if import_path is not None:
        params = trainer.load(import_path, params)
    os.makedirs(out_dir, exist_ok=True)
    all_traces = []
    for batch in loader:
        _, objects, obj_mask, arrays = to_device_batch(batch, trainer.device)
        with torch.inference_mode():
            out = interp.forward(params, objects, obj_mask, arrays, batch.spec, False, None,
                                 return_trace=True)
        entries = trace_to_dict(batch, out, out["trace"])
        all_traces.extend(entries)
        if image_path and os.path.isdir(image_path):
            box_dim = batch.objects.shape[-1] - 6
            img_index = batch.arrays.get("img_index")
            for qi, entry in enumerate(entries):
                # objects are stored per unique image; map question -> row
                row = int(img_index[qi]) if img_index is not None else qi
                bboxes = batch.objects[row, :, box_dim + 2:]
                render_question(
                    image_path, entry["image_id"], bboxes,
                    [h["attention"] for h in entry["hops"]],
                    [f"{h['op']}({h['token']})" for h in entry["hops"]],
                    os.path.join(out_dir, f"{entry['question_id']}.png"), show=show)
    with open(os.path.join(out_dir, "traces.json"), "w") as f:
        json.dump(all_traces, f)
    return all_traces
