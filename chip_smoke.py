#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA card.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card, ``nvcc`` (from ``CUDA_HOME`` or ``/usr/local/cuda``) and no network,
and it imports nothing of JAX. Phases, one line each:

1. device: torch and CUDA versions, the card's name and power limit
2. build: the CUDA kernels from ``deeplearningexamples_tpu_torch/csrc``, one
   nvcc per source, all started together
3. kernel: flash_fwd (K1) against its plain version on the card, with times
4. slice: full-width BERT-Large QA (24 layers, random weights from one seed)
   on the card against the same model on the CPU
5. serving: bf16 BERT-Large QA behind the batcher and HTTP server, 16
   concurrent JSON and binary requests against a direct forward
6. predict_squad: three hand-written questions answered from their context
7. kernel: the flash backward's two kernels (K2) against the plain backward
8. kernel: the flat LAMB's two passes (K3) against their plain versions on
   BERT-Large's flat layout, three steps, bf16 and fp32 moments
9. train parity: one fp32 training step of full-width BERT-Large on the
   card against the CPU, then the same step in bf16
10. training: ``bert-pretrain`` through the CLI's runner, 10 steps at B=64
    S=128 with the tree LAMB and with ``--flat-lamb``, then 2 steps of
    ``--phase2`` (S=512, B=8)

Each main path (serving: phases 5-6; training: phase 10) runs with the
launch counts set to 0 just before it and read just after. Then one JSON
line with each kernel's launches on those paths, its error against the plain
version, its time, the plain version's, its bound on this card and the time
of the PyTorch call that computes the same function (where there is one),
and last ``{"ok": true, "device": {...}}``. Any failed check raises and the
script exits non-zero; without a CUDA card it fails before printing a result.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

from deeplearningexamples_tpu_torch.data.squad import (
    convert_examples_to_features,
    read_squad_examples,
)
from deeplearningexamples_tpu_torch.data.tokenization import BertTokenizer
from deeplearningexamples_tpu_torch.cli.main import cli
from deeplearningexamples_tpu_torch.core import flat
from deeplearningexamples_tpu_torch.core.train import (
    create_train_state,
    make_train_step,
)
from deeplearningexamples_tpu_torch.data.synthetic import SyntheticBertLoader
from deeplearningexamples_tpu_torch.models.bert import (
    BERT_CONFIGS,
    BertForPreTraining,
    BertPretrainTask,
    BertSquadTask,
    predict_squad,
)
from deeplearningexamples_tpu_torch.ops import _build
from deeplearningexamples_tpu_torch.ops import flash_attention as fa
from deeplearningexamples_tpu_torch.ops.lamb import lamb
from deeplearningexamples_tpu_torch.utils.jax_bridge import bert_pretrain_jax_order
from deeplearningexamples_tpu_torch.serving import (
    ContinuousBatcher,
    InferenceServer,
    ModelEndpoint,
    http_infer,
)

SEED = 0
DEV = "cuda:0"
ROOT = Path(__file__).resolve().parent
B, S, H, D = 8, 384, 16, 64  # the BERT-Large attention shape served here
TB, TS = 64, 128  # the pretraining shape (phase 1 of BERT pretraining)
LAYERS = BERT_CONFIGS["large"].num_layers
INPUTS = ("input_ids", "attention_mask", "token_type_ids")
# Published peaks of one H100 SXM (dense): bf16 on the tensor cores, fp32 on
# the FMA pipe, and device memory; a bound is the larger of the two times
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12

# Kernel against plain on the card. fp32: the online softmax sums in another
# order than the plain version's full-row softmax. bf16: P is rounded to bf16
# against a different running maximum, so out differs by about one bf16 ulp
# of values near 1; lse stays in fp32 on both sides.
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-3)}
# The fp32 slice on the card against the CPU: 24 layers of fp32 GEMMs whose
# sums run in another order (TF32 is off).
TOL_SLICE_F32 = 1e-3
# bf16 on the card against fp32 on the CPU: a sanity floor for the direction
# of the logits, not a parity claim.
MIN_COS_BF16 = 0.99
# A request served in a batch of 1-8 against the same request in a batch of
# 16: bf16 GEMMs of other shapes round differently.
TOL_SERVED = 5e-2
# K2 against the plain backward, relative to the largest gradient entry:
# fp32 sums run in another order; bf16 rounds dS and P from fp32 values that
# differ in the last bits, so an entry can move by a bf16 ulp before the sums.
TOL_BWD = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# K3 against the plain passes after three steps, relative to the largest
# parameter: the kernel may fuse a multiply-add the plain version rounds
# twice, and a bf16 moment that lands an ulp apart moves u by 2**-8 of itself
TOL_LAMB = {torch.float32: 1e-6, torch.bfloat16: 1e-4}
# One fp32 training step, card against CPU (TF32 off). The loss and the
# gradient norm to the sums' order (the CPU's norms sum in fp64 across chunks,
# ops/lamb.py). The parameters to 1e-3 of the largest update, because LAMB's
# first step u = g / (|g| + eps) turns the rounding noise of a near-zero
# gradient (the key biases', whose true gradient is 0) into a visible share of
# a (small) update.
#
# Each gradient tensor to 1e-4 of the largest gradient entry (max abs error):
# on an H100 the sound reading is about 1.4e-6 and the same step in bf16, the
# control, reads about 1.2e-2 against the fp32 CPU; a wrong dq, dk or dv in
# one layer moves its attention weights' gradients by far more than 1e-4 of
# the largest entry, where the loss, the norm and LAMB's first update (about
# lr * sign(g)) hardly move.
TOL_STEP = {"loss": 1e-5, "grad_norm": 1e-4, "update": 1e-3, "grad": 1e-4}
# bert-pretrain's learning rate in these runs: configs.yml's phase-1 LAMB rate
# (the CLI's own default, 0.1, is CommonConfig's and throws BERT-Large's loss
# up to 20 before it falls)
PRETRAIN_LR = "0.006"
# The tree and the flat LAMB take the same first update (lr(0) = lr(1) with
# one warmup step) but for the trust ratio, which the flat path takes from the
# moments before they are rounded to bf16: the second step's losses agree to
# that rounding.
TOL_TREE_FLAT = 1e-3
# bf16 step on the card against the fp32 step on the CPU: a floor on the
# cosine of the gradients, not a parity claim.
MIN_COS_GRAD_BF16 = 0.99


def _reset_counts() -> None:
    fa.launches = fa.launches_bwd_dq = fa.launches_bwd_dkv = 0
    flat.launches_moments = flat.launches_apply = 0


def _counts() -> dict[str, int]:
    return {"flash_fwd": fa.launches, "flash_bwd_dq": fa.launches_bwd_dq,
            "flash_bwd_dkv": fa.launches_bwd_dkv,
            "flat_lamb_moments": flat.launches_moments,
            "flat_lamb_apply": flat.launches_apply}


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float().cpu() - b.float().cpu()).abs().max())


# -- phase 1 -----------------------------------------------------------------


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    # the fp32 checks compare full fp32 arithmetic
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    say("1 device", f"{name} x{torch.cuda.device_count()}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}")
    return name


# -- phase 2 -----------------------------------------------------------------


def phase_build() -> None:
    nvcc = _build.nvcc()
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, check=True, timeout=60).stdout
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    say("2 build", f"{lib.name} ready in {time.perf_counter() - t0:.2f} s "
        f"({nvcc}: {version.strip().splitlines()[-1]})")


# -- phase 3 -----------------------------------------------------------------


def _attn_inputs(b, s, h, d, dtype, layout, masked=True, seed=SEED):
    g = torch.Generator().manual_seed(seed)
    shape = (b, s, h, d) if layout == "bshd" else (b, h, s, d)
    q, k, v = (torch.randn(shape, generator=g).to(DEV, dtype) for _ in range(3))
    mask = None
    if masked:
        lengths = torch.randint(s // 4, s + 1, (b,), generator=g)
        mask = (torch.arange(s)[None, :] < lengths[:, None]).to(torch.int32)
        mask[-1] = 0  # one batch row with every key masked
        mask = mask.to(DEV)
    return q, k, v, mask


def _bound(bytes_: float, flops: float, dtype) -> tuple[float, str]:
    """The least time this card could take: bytes over the memory rate or
    operations over the peak rate of their type, whichever is larger."""
    t_bytes = bytes_ / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _event_ms(fn, iters: int = 50) -> float:
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_kernel() -> dict:
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        cases += [
            dict(b=B, s=S, h=H, d=D, dtype=dtype, layout="bshd"),
            dict(b=B, s=S, h=H, d=D, dtype=dtype, layout="bhsd"),
            dict(b=4, s=S, h=H, d=32, dtype=dtype, layout="bshd"),
            dict(b=4, s=S, h=8, d=128, dtype=dtype, layout="bshd"),
            dict(b=1, s=2048, h=H, d=D, dtype=dtype, layout="bshd",
                 masked=False, causal=True),
            # causal with a fully masked row: the skipped tiles still count
            dict(b=2, s=520, h=4, d=D, dtype=dtype, layout="bshd", causal=True),
            dict(b=B, s=S, h=H, d=D, dtype=dtype, layout="bshd", rate=0.1,
                 seed=-1234567),
            # the training shape of --phase2, with its dropout
            dict(b=8, s=512, h=H, d=D, dtype=dtype, layout="bshd", rate=0.1,
                 seed=-7654321),
        ]
    worst = 0.0
    for c in cases:
        q, k, v, mask = _attn_inputs(c["b"], c["s"], c["h"], c["d"],
                                     c["dtype"], c["layout"],
                                     c.get("masked", True))
        kw = dict(causal=c.get("causal", False), layout=c["layout"],
                  dropout_rate=c.get("rate", 0.0),
                  dropout_seed=c.get("seed", 0))
        before = fa.launches
        out, lse = fa.flash_attention_with_lse(q, k, v, mask, **kw)
        torch.cuda.synchronize()
        check(fa.launches == before + 1, f"kernel not launched for {c}")
        ref, ref_lse = fa.mha_reference(q, k, v, mask, kw["causal"],
                                        layout=kw["layout"],
                                        dropout_rate=kw["dropout_rate"],
                                        dropout_seed=kw["dropout_seed"])
        e_out, e_lse = max_err(out, ref), max_err(lse, ref_lse)
        tol_out, tol_lse = TOL[c["dtype"]]
        finite = {name: bool(torch.isfinite(t.float()).all()) for name, t in
                  (("out", out), ("lse", lse), ("plain out", ref),
                   ("plain lse", ref_lse))}
        check(e_out <= tol_out and e_lse <= tol_lse,
              f"kernel vs plain {c}: out {e_out:.3e} lse {e_lse:.3e}; "
              f"finite: {finite}")
        worst = max(worst, e_out)
        c["err"] = (e_out, e_lse)

    q, k, v, mask = _attn_inputs(B, S, H, D, torch.bfloat16, "bshd")

    def kernel():
        return fa.flash_attention(q, k, v, mask, layout="bshd")

    def plain():
        return fa.mha_reference(q, k, v, mask, layout="bshd")

    sdpa_mask = mask.bool()[:, None, None, :]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=sdpa_mask)

    with torch.inference_mode():
        # in turns, plain and kernel, to spread drift over both
        plain_ms = [_event_ms(plain)]
        kernel_ms = [_event_ms(kernel), _event_ms(kernel)]
        plain_ms.append(_event_ms(plain))
        library_ms = _event_ms(library)
    n = B * S * H * D
    bound_ms, bound_by = _bound(
        bytes_=4 * n * 2 + B * H * S * 4 + B * S * 4,  # q, k, v, out; lse; mask
        flops=4 * B * H * S * S * D, dtype=torch.bfloat16)
    errs = ", ".join(
        f"{'f32' if c['dtype'] == torch.float32 else 'bf16'} {c['layout']} "
        f"b{c['b']} s{c['s']} h{c['h']} d{c['d']}"
        f"{' causal' if c.get('causal') else ''}"
        f"{' drop' if c.get('rate') else ''}: {c['err'][0]:.2e}/{c['err'][1]:.2e}"
        for c in cases)
    say("3 kernel", f"flash_fwd vs plain, max abs err out/lse: {errs}; "
        f"bf16 b{B} s{S} h{H} d{D} masked: kernel {min(kernel_ms):.4f} ms, "
        f"plain {min(plain_ms):.4f} ms, scaled_dot_product_attention "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) "
        f"(CUDA events, 50 iters)")
    return {"max_abs_err": worst, "ms": min(kernel_ms), "plain_ms": min(plain_ms),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


# -- phase 4 -----------------------------------------------------------------


def _qa_batch(rng, n: int, seq: int = S) -> dict[str, np.ndarray]:
    lengths = rng.integers(seq // 3, seq + 1, size=n)
    ids = rng.integers(1000, 30522, size=(n, seq)).astype(np.int32)
    mask = (np.arange(seq)[None, :] < lengths[:, None]).astype(np.int32)
    ids *= mask
    seg = ((np.arange(seq)[None, :] >= lengths[:, None] // 3) & (mask > 0))
    return {"input_ids": ids, "attention_mask": mask,
            "token_type_ids": seg.astype(np.int32)}


def _forward(task, model, batch, device):
    t = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    return [x.float().cpu() for x in task.predict_fn(model, t)]


def phase_slice():
    cfg = BERT_CONFIGS["large"]
    t0 = time.perf_counter()
    task32 = BertSquadTask(cfg, dtype=torch.float32)
    cpu_model = task32.init(torch.Generator().manual_seed(SEED), device="cpu")
    batch = _qa_batch(np.random.default_rng(SEED), 2)

    gpu32 = task32.place(copy.deepcopy(cpu_model), DEV)
    before = fa.launches
    got32 = _forward(task32, gpu32, batch, DEV)
    check(fa.launches - before == LAYERS,
          f"fp32 forward launched {fa.launches - before}, want {LAYERS}")
    del gpu32
    want = _forward(task32, cpu_model, batch, "cpu")
    err32 = max(max_err(g, w) for g, w in zip(got32, want))
    check(err32 <= TOL_SLICE_F32, f"fp32 card vs CPU logits: {err32:.3e}")

    task16 = BertSquadTask(cfg, dtype=torch.bfloat16)
    gpu16 = task16.place(copy.deepcopy(cpu_model), DEV)
    before = fa.launches
    got16 = _forward(task16, gpu16, batch, DEV)
    check(fa.launches - before == LAYERS,
          f"bf16 forward launched {fa.launches - before}, want {LAYERS}")
    err16 = max(max_err(g, w) for g, w in zip(got16, want))
    cos = min(float(torch.nn.functional.cosine_similarity(
        g.flatten(), w.flatten(), dim=0)) for g, w in zip(got16, want))
    check(all(bool(torch.isfinite(g).all()) for g in got16), "bf16 non-finite")
    check(cos >= MIN_COS_BF16, f"bf16 vs fp32 cosine {cos:.5f}")
    say("4 slice", f"BERT-Large QA b2 s{S} padded: fp32 card vs CPU max abs "
        f"err {err32:.3e}; bf16 card vs fp32 CPU max abs err {err16:.3e}, "
        f"cosine {cos:.6f}; {LAYERS} launches per forward; "
        f"{time.perf_counter() - t0:.1f} s")
    return task16, gpu16


# -- phase 5 -----------------------------------------------------------------


def phase_serving(task, model) -> int:
    """Serves 16 concurrent requests; returns the launches they caused."""
    def infer(batch):
        start, end = task.predict_fn(
            model, {k: torch.from_numpy(v).to(DEV) for k, v in batch.items()})
        return {"start_logits": start, "end_logits": end}

    rng = np.random.default_rng(SEED + 1)
    flat = _qa_batch(rng, 16)
    reqs = [{k: flat[k][i] for k in INPUTS} for i in range(16)]
    direct = {k: v.cpu().numpy() for k, v in infer(flat).items()}

    batcher = ContinuousBatcher(infer, batch_buckets=(1, 2, 4, 8),
                                max_delay_s=0.005)
    batcher.warmup(reqs[0])  # build and first launches off the dispatcher
    server = InferenceServer("127.0.0.1", 0)
    server.register(ModelEndpoint(
        name="bert_large_qa", batcher=batcher,
        input_spec={k: ((S,), "int32") for k in INPUTS},
        output_names=("start_logits", "end_logits")))
    server.start()
    try:
        base = f"http://{server.addr[0]}:{server.addr[1]}/v2"
        with urllib.request.urlopen(f"{base}/health/ready", timeout=30) as r:
            check(json.loads(r.read()).get("ready") is True, "not ready")
        results: list = [None] * len(reqs)
        errors: list = []

        def client(i):
            try:
                results[i] = http_infer(server.addr, "bert_large_qa", reqs[i],
                                        binary=i % 2 == 1)
            except Exception as e:  # noqa: BLE001 - re-raised below
                errors.append(e)

        _reset_counts()  # the serving path starts here
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        launched = fa.launches
        check(not any(t.is_alive() for t in threads), "requests hung")
        if errors:
            raise errors[0]
        worst = 0.0
        for i, res in enumerate(results):
            for name in ("start_logits", "end_logits"):
                got = np.asarray(res["outputs"][name], np.float32)
                check(got.shape == (S,), f"request {i} {name} {got.shape}")
                worst = max(worst, float(np.abs(got - direct[name][i]).max()))
        check(worst <= TOL_SERVED, f"served vs direct: {worst:.3e}")
        with urllib.request.urlopen(f"{base}/models/bert_large_qa/stats",
                                    timeout=30) as r:
            stats = json.loads(r.read())
        check(stats == batcher.stats(), "stats route disagrees with batcher")
        check(launched == LAYERS * stats["dispatches"],
              f"{launched} launches for {stats['dispatches']} dispatches")
    finally:
        server.stop()
    say("5 serving", f"16 requests (8 JSON, 8 binary) answered, max abs err "
        f"vs direct forward {worst:.3e}; dispatches {stats['dispatches']}, "
        f"mean_batch {stats['mean_batch']:.2f}, device_ms p50 "
        f"{stats['device_ms_p50']:.2f} p95 {stats['device_ms_p95']:.2f}, "
        f"wait_ms p50 {stats['wait_ms_p50']:.2f}")
    return launched


# -- phase 6 -----------------------------------------------------------------

SQUAD = {"data": [{"title": "smoke", "paragraphs": [{
    "context": "The Normans were the people who in the 10th and 11th "
               "centuries gave their name to Normandy, a region in France. "
               "They were descended from Norse raiders led by their chief "
               "Rollo, who swore fealty to King Charles III of West Francia.",
    "qas": [
        {"id": "q1", "question": "In what country is Normandy?",
         "answers": [{"text": "France", "answer_start": 104}]},
        {"id": "q2", "question": "Who led the Norse raiders?",
         "answers": [{"text": "Rollo", "answer_start": 170}]},
        {"id": "q3", "question": "To which king did Rollo swear fealty?",
         "answers": [{"text": "King Charles III", "answer_start": 197}]},
    ],
}]}]}


def phase_predict(task, model) -> int:
    para = SQUAD["data"][0]["paragraphs"][0]
    words = sorted({w for text in [para["context"]]
                    + [qa["question"] for qa in para["qas"]]
                    for w in BertTokenizer({}).basic.tokenize(text)})
    vocab = {w: i for i, w in enumerate(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words)}
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "dev.json"
        path.write_text(json.dumps(SQUAD))
        examples = read_squad_examples(str(path), is_training=False)
    feats = convert_examples_to_features(
        examples, BertTokenizer(vocab), max_seq_length=S, doc_stride=128,
        is_training=False)
    before = fa.launches
    preds = predict_squad(task, model, feats, batch_size=8)
    launched = fa.launches - before
    check(launched == LAYERS * -(-len(feats) // 8),
          f"predict_squad launched {launched} for {len(feats)} features")
    check(set(preds) == {qa["id"] for qa in para["qas"]}, f"answers {preds}")
    for qid, text in preds.items():
        check(bool(text) and text in para["context"],
              f"{qid}: {text!r} is not a span of the context")
    say("6 predict_squad", f"{len(feats)} features -> "
        + "; ".join(f"{q}: {t!r}" for q, t in sorted(preds.items())))
    return launched


# -- phase 7 -----------------------------------------------------------------


def phase_flash_bwd() -> tuple[float, dict]:
    """K2 against the plain backward in every layout, dtype and head dim the
    kernels take, and K1's forward at the same shapes (the training shapes
    among them) against its plain version; times at the pretraining shape.
    Returns K1's worst error here and K2's results."""
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        cases += [
            dict(b=TB, s=TS, h=16, d=64, dtype=dtype, layout="bshd"),
            dict(b=B, s=S, h=H, d=D, dtype=dtype, layout="bhsd"),
            dict(b=4, s=S, h=H, d=32, dtype=dtype, layout="bshd"),
            dict(b=4, s=S, h=8, d=128, dtype=dtype, layout="bshd"),
            dict(b=1, s=2048, h=H, d=D, dtype=dtype, layout="bshd",
                 masked=False, causal=True),
            # causal with a fully masked row: the skipped tiles still count
            dict(b=2, s=520, h=4, d=D, dtype=dtype, layout="bhsd", causal=True),
            dict(b=TB, s=TS, h=16, d=64, dtype=dtype, layout="bshd", rate=0.1,
                 seed=-1234567),
            dict(b=8, s=512, h=16, d=64, dtype=dtype, layout="bshd", rate=0.1,
                 seed=-7654321),
        ]
    worst, worst_rel, worst_fwd = 0.0, 0.0, 0.0
    for c in cases:
        q, k, v, mask = _attn_inputs(c["b"], c["s"], c["h"], c["d"], c["dtype"],
                                     c["layout"], c.get("masked", True))
        kw = dict(causal=c.get("causal", False), layout=c["layout"],
                  dropout_rate=c.get("rate", 0.0), dropout_seed=c.get("seed", 0))
        dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(1)
                           ).to(DEV, c["dtype"])
        for t in (q, k, v):
            t.requires_grad_()
        out, lse = fa.flash_attention_with_lse(q, k, v, mask, **kw)
        # K1 at this shape too: the training path's forward
        ref, ref_lse = fa.mha_reference(q.detach(), k.detach(), v.detach(),
                                        mask, **kw)
        e_out, e_lse = max_err(out, ref), max_err(lse, ref_lse)
        tol_out, tol_lse = TOL[c["dtype"]]
        check(e_out <= tol_out and e_lse <= tol_lse,
              f"K1 vs plain {c}: out {e_out:.3e} lse {e_lse:.3e}")
        worst_fwd = max(worst_fwd, e_out)
        del ref, ref_lse
        before = (fa.launches_bwd_dq, fa.launches_bwd_dkv)
        out.backward(dout)
        torch.cuda.synchronize()
        check((fa.launches_bwd_dq, fa.launches_bwd_dkv)
              == (before[0] + 1, before[1] + 1), f"K2 not launched for {c}")
        want = fa.mha_backward_reference(
            q.detach(), k.detach(), v.detach(), mask, out.detach(), lse, dout,
            kw["causal"], layout=kw["layout"], dropout_rate=kw["dropout_rate"],
            dropout_seed=kw["dropout_seed"])
        errs = []
        for name, got, ref in zip("qkv", (q.grad, k.grad, v.grad), want):
            err, scale = max_err(got, ref), float(ref.float().abs().max())
            check(math.isfinite(err) and err <= TOL_BWD[c["dtype"]] * scale,
                  f"K2 vs plain {c}: d{name} err {err:.3e}, largest {scale:.3e}")
            errs.append(err)
            worst_rel = max(worst_rel, err / max(scale, 1e-30))
        worst = max(worst, *errs)
        c["err"] = (max(errs), e_out, e_lse)

    # times at the pretraining shape, bf16, masked (dropout off)
    q, k, v, mask = _attn_inputs(TB, TS, 16, 64, torch.bfloat16, "bshd")
    with torch.no_grad():
        out, lse = fa.flash_attention_with_lse(q, k, v, mask, layout="bshd")
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(2)
                       ).to(DEV, torch.bfloat16)
    scale = 1.0 / math.sqrt(64)
    _, args, _keep = fa._bwd_buffers(q, k, v, mask, out, lse, dout, False,
                                     scale, "bshd", 0.0, 0)
    stream = torch.cuda.current_stream().cuda_stream
    dq_fn, dkv_fn = fa._kernel("dlx_flash_bwd_dq"), fa._kernel("dlx_flash_bwd_dkv")

    def dq_kernel():
        check(dq_fn(*args, stream) == 0, "flash_bwd_dq launch failed")

    def dkv_kernel():  # reads the delta the dq kernel wrote
        check(dkv_fn(*args, stream) == 0, "flash_bwd_dkv launch failed")

    def plain():
        return fa.mha_backward_reference(q, k, v, mask, out, lse, dout,
                                         layout="bshd")

    qs, ks, vs = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
    lib_out = torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask.bool()[:, None, None, :])
    lib_dout = dout.transpose(1, 2)

    def library():  # the backward only, through autograd
        return torch.autograd.grad(lib_out, (qs, ks, vs), lib_dout,
                                   retain_graph=True)

    dq_kernel()
    plain_ms = [_event_ms(plain, 20)]
    dq_ms = [_event_ms(dq_kernel), _event_ms(dq_kernel)]
    dkv_ms = [_event_ms(dkv_kernel), _event_ms(dkv_kernel)]
    plain_ms.append(_event_ms(plain, 20))
    library_ms = _event_ms(library, 20)
    n = TB * TS * 16 * 64
    rows = TB * 16 * TS  # lse and delta entries
    mask_bytes = TB * TS * 4
    # dq: reads q, k, v, out, dout, lse, mask; writes dq, delta; s, dp, dq
    dq_bound = _bound(6 * n * 2 + 2 * rows * 4 + mask_bytes,
                      6 * TB * 16 * TS * TS * 64, torch.bfloat16)
    # dk/dv: reads q, k, v, dout, lse, delta, mask; writes dk, dv; s, dp, dv, dk
    dkv_bound = _bound(6 * n * 2 + 2 * rows * 4 + mask_bytes,
                       8 * TB * 16 * TS * TS * 64, torch.bfloat16)
    errs = ", ".join(
        f"{'f32' if c['dtype'] == torch.float32 else 'bf16'} {c['layout']} "
        f"b{c['b']} s{c['s']} h{c['h']} d{c['d']}"
        f"{' causal' if c.get('causal') else ''}"
        f"{' drop' if c.get('rate') else ''}: {c['err'][0]:.2e} "
        f"(forward {c['err'][1]:.2e}/{c['err'][2]:.2e})" for c in cases)
    say("7 kernel", f"flash_bwd (dq, dk/dv kernels) vs plain, max abs err of "
        f"dq/dk/dv (and of flash_fwd's out/lse): {errs}; worst relative to "
        f"the largest entry "
        f"{worst_rel:.2e}; bf16 b{TB} s{TS} h16 d64 masked: dq kernel "
        f"{min(dq_ms):.4f} ms (bound {dq_bound[0]:.4f}, {dq_bound[1]}), dk/dv "
        f"kernel {min(dkv_ms):.4f} ms (bound {dkv_bound[0]:.4f}, "
        f"{dkv_bound[1]}), plain backward {min(plain_ms):.4f} ms, "
        f"scaled_dot_product_attention backward {library_ms:.4f} ms "
        f"(CUDA events)")
    common = {"max_abs_err": worst, "plain_ms": min(plain_ms),
              "library_ms": library_ms}
    return worst_fwd, {
        "flash_bwd_dq": {**common, "ms": min(dq_ms), "bound_ms": dq_bound[0],
                         "bound_by": dq_bound[1]},
        "flash_bwd_dkv": {**common, "ms": min(dkv_ms), "bound_ms": dkv_bound[0],
                          "bound_by": dkv_bound[1]},
    }


# -- phase 8 -----------------------------------------------------------------


class _PlainFlatPasses:
    """Runs ``flat_lamb``'s update with the plain passes, on the card."""

    def __enter__(self):
        self._saved = (flat.flat_lamb_moments, flat.flat_lamb_apply)
        flat.flat_lamb_moments = flat._moments_plain
        flat.flat_lamb_apply = flat._apply_plain

    def __exit__(self, *exc):
        flat.flat_lamb_moments, flat.flat_lamb_apply = self._saved


def _large_layout():
    with torch.device("meta"):
        model = BertForPreTraining(BERT_CONFIGS["large"])
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    return flat.make_layout_blocked(
        [(n, shapes[n]) for n in bert_pretrain_jax_order(LAYERS)])


def phase_flat_lamb() -> dict:
    """K3 on BERT-Large's flat layout: three steps of flat_lamb with the
    kernels against the same three with the plain passes, from one set of
    random g, p, m, v; then each pass timed."""
    layout = _large_layout()
    rows = layout.total // flat.LANES
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    p0 = torch.randn(rows, flat.LANES, generator=gen, device=DEV) * 0.02
    grads = [torch.randn(rows, flat.LANES, generator=gen, device=DEV) * 1e-3
             for _ in range(3)]
    m0 = torch.randn(rows, flat.LANES, generator=gen, device=DEV) * 1e-4
    v0 = torch.rand(rows, flat.LANES, generator=gen, device=DEV) * 1e-7
    wd = np.asarray([0.01 if flat.default_wd_mask([n])[n] else 0.0
                     for n in layout.names], np.float32)
    sched = lambda count: 1e-3 * count  # noqa: E731
    errs = {}
    for mdt in (torch.float32, torch.bfloat16):
        tx = flat.flat_lamb(sched, layout, wd, moment_dtype=mdt)
        out = {}
        for kind in ("kernel", "plain"):
            p = p0.clone()
            state = flat.FlatLambState(0, m0.to(mdt, copy=True),
                                       v0.to(mdt, copy=True))
            before = (flat.launches_moments, flat.launches_apply)
            if kind == "plain":
                with _PlainFlatPasses():
                    for g in grads:
                        p, state = tx.update(g, state, p)
            else:
                for g in grads:
                    p, state = tx.update(g, state, p)
                check((flat.launches_moments, flat.launches_apply)
                      == (before[0] + 3, before[1] + 3), "K3 not launched")
            torch.cuda.synchronize()
            out[kind] = (p, state)
        (pk, sk), (pp, sp) = out["kernel"], out["plain"]
        err = max_err(pk, pp)
        scale = float(pp.abs().max())
        check(math.isfinite(err) and err <= TOL_LAMB[mdt] * scale,
              f"K3 vs plain ({mdt}): p err {err:.3e}, largest {scale:.3e}")
        m_err = max_err(sk.flat_m, sp.flat_m)
        check(m_err <= 1e-2 * float(sp.flat_m.float().abs().max()),
              f"K3 vs plain ({mdt}): m err {m_err:.3e}")
        errs[mdt] = (err, m_err)
        del out, pk, pp, sk, sp

    # times: bf16 moments, the CLI default, on fixed inputs
    seg = torch.as_tensor(layout.seg_ids, dtype=torch.int32, device=DEV)
    wd_t = torch.as_tensor(wd, device=DEV)
    hyp = torch.tensor([0.9, 0.999, 1e-6, 0.1, 0.001, 0.5], device=DEV)
    scale_leaf = torch.full((layout.n_leaves,), 1e-3, device=DEV)
    p, g = p0.clone(), grads[0]
    m, v = m0.to(torch.bfloat16), v0.to(torch.bfloat16)

    def moments():
        flat.flat_lamb_moments(g, p, m, v, seg, wd_t, hyp)

    def apply():
        flat.flat_lamb_apply(p, m, v, seg, wd_t, hyp, scale_leaf)

    def plain():
        flat._moments_plain(g, p, m, v, seg, wd_t, hyp)
        flat._apply_plain(p, m, v, seg, wd_t, hyp, scale_leaf)

    plain_ms = [_event_ms(plain, 5)]
    mom_ms = [_event_ms(moments, 10), _event_ms(moments, 10)]
    app_ms = [_event_ms(apply, 10), _event_ms(apply, 10)]
    plain_ms.append(_event_ms(plain, 5))
    n = layout.total
    nb = len(layout.seg_ids)
    # pass 1 reads g, p (fp32), m, v (bf16), writes m, v and the partials;
    # about 20 fp32 operations an element
    mom_bound = _bound(n * (4 + 4 + 2 + 2 + 2 + 2) + nb * 8 + nb * 4,
                       20 * n, torch.float32)
    # pass 2 reads p, m, v, writes p; about 10 operations an element
    app_bound = _bound(n * (4 + 2 + 2 + 4) + nb * 4, 10 * n, torch.float32)
    say("8 kernel", f"flat_lamb passes vs plain on BERT-Large's layout "
        f"({n} elements, {layout.n_leaves} tensors, {nb} blocks), 3 steps: "
        f"max abs err p/m fp32 moments {errs[torch.float32][0]:.2e}/"
        f"{errs[torch.float32][1]:.2e}, bf16 moments "
        f"{errs[torch.bfloat16][0]:.2e}/{errs[torch.bfloat16][1]:.2e}; bf16 "
        f"moments: moments pass {min(mom_ms):.4f} ms (bound "
        f"{mom_bound[0]:.4f}, {mom_bound[1]}), apply pass {min(app_ms):.4f} ms "
        f"(bound {app_bound[0]:.4f}, {app_bound[1]}), plain both passes "
        f"{min(plain_ms):.4f} ms; no single PyTorch call computes LAMB")
    worst = max(e[0] for e in errs.values())
    common = {"max_abs_err": worst, "plain_ms": min(plain_ms), "library_ms": None}
    return {
        "flat_lamb_moments": {**common, "ms": min(mom_ms),
                              "bound_ms": mom_bound[0], "bound_by": mom_bound[1]},
        "flat_lamb_apply": {**common, "ms": min(app_ms),
                            "bound_ms": app_bound[0], "bound_by": app_bound[1]},
    }


# -- phase 9 -----------------------------------------------------------------


def _pretrain_batch(b: int, s: int, p: int) -> dict:
    batch = next(iter(SyntheticBertLoader(
        b, s, BERT_CONFIGS["large"].vocab_size, p, steps=1)))
    batch = {k: v.copy() for k, v in batch.items()}
    batch["attention_mask"][-1, s // 2:] = 0  # one padded row
    return batch


def _train_one_step(model, dtype, batch, device):
    cfg = dataclasses.replace(BERT_CONFIGS["large"], hidden_dropout=0.0,
                              attention_dropout=0.0)
    task = BertPretrainTask(cfg, dtype, max_predictions=20)
    params = dict(model.named_parameters())
    tx = lamb(1e-3, weight_decay=0.01, moment_dtype=torch.float32,
              mask={n: p.ndim > 1 for n, p in params.items()})
    state = create_train_state(model, tx, SEED, params=params)
    step = make_train_step(task.loss_fn, tx)
    t = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    before = {n: p.detach().clone() for n, p in params.items()}
    state, metrics = step(state, t)
    return ({k: float(v) for k, v in metrics.items()},
            {n: p.grad.detach() for n, p in params.items()},
            {n: (p.detach() - before[n]) for n, p in params.items()})


def phase_train_parity() -> None:
    cfg = dataclasses.replace(BERT_CONFIGS["large"], hidden_dropout=0.0,
                              attention_dropout=0.0)
    t0 = time.perf_counter()
    init = BertPretrainTask(cfg, torch.float32).init(
        torch.Generator().manual_seed(SEED), device="cpu")
    batch = _pretrain_batch(2, TS, 20)
    gpu = copy.deepcopy(init).to(DEV)
    before = dict(_counts())
    m_gpu, g_gpu, d_gpu = _train_one_step(gpu, torch.float32, batch, DEV)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in _counts().items()}
    check(launched["flash_fwd"] == LAYERS and launched["flash_bwd_dq"] == LAYERS
          and launched["flash_bwd_dkv"] == LAYERS,
          f"one step launched {launched}, want {LAYERS} of each flash kernel")
    del gpu
    cpu = copy.deepcopy(init)
    m_cpu, g_cpu, d_cpu = _train_one_step(cpu, torch.float32, batch, "cpu")
    del cpu
    rel = {key: abs(m_gpu[key] - m_cpu[key]) / abs(m_cpu[key])
           for key in ("loss", "grad_norm")}
    upd = max(float(d.abs().max()) for d in d_cpu.values())
    p_err, p_worst = max((max_err(d_gpu[n], d_cpu[n]), n) for n in d_cpu)
    g_top = max(float(g.abs().max()) for g in g_cpu.values())
    g_rel = sorted(((max_err(g_gpu[n], g_cpu[n]) / g_top, n) for n in g_cpu),
                   reverse=True)
    del d_gpu, g_gpu

    gpu16 = BertForPreTraining(cfg, torch.bfloat16)  # bf16 compute, fp32 params
    gpu16.load_state_dict(init.state_dict())
    m16, g16, _ = _train_one_step(gpu16.to(DEV), torch.bfloat16, batch, DEV)
    del gpu16
    # in fp64: an fp32 dot product over 336M entries is not exact enough
    a = torch.cat([g16[n].cpu().double().flatten() for n in g_cpu])
    b = torch.cat([g_cpu[n].double().flatten() for n in g_cpu])
    cos = float(a @ b / (a.norm() * b.norm()))
    # the control of the gradient check: the bf16 step read the same way
    g16_rel = max((max_err(g16[n], g_cpu[n]) / g_top, n) for n in g_cpu)
    say("9 train parity", f"BERT-Large pretraining b2 s{TS} fp32, one LAMB "
        f"step, card vs CPU: loss {m_gpu['loss']:.6f} vs {m_cpu['loss']:.6f} "
        f"({rel['loss']:.2e}), grad_norm {m_gpu['grad_norm']:.6f} vs "
        f"{m_cpu['grad_norm']:.6f} ({rel['grad_norm']:.2e}), worst gradients "
        f"(max abs err over the largest gradient entry {g_top:.3e}): "
        + ", ".join(f"{n} {r:.2e}" for r, n in g_rel[:3])
        + f" (limit {TOL_STEP['grad']:.0e}); params max abs diff {p_err:.3e} in "
        f"{p_worst} (largest update {upd:.3e}); "
        f"bf16 card step: loss {m16['loss']:.6f}, gradient cosine vs fp32 CPU "
        f"{cos:.6f}, worst gradient {g16_rel[1]} {g16_rel[0]:.2e} of the "
        f"largest entry (the control); {time.perf_counter() - t0:.1f} s")
    for key in ("loss", "grad_norm"):
        check(rel[key] <= TOL_STEP[key], f"fp32 step {key}: card {m_gpu[key]} "
              f"vs CPU {m_cpu[key]} ({rel[key]:.2e})")
    check(g_rel[0][0] <= TOL_STEP["grad"],
          f"fp32 step gradients: {g_rel[0][1]} {g_rel[0][0]:.3e} of the "
          f"largest entry, card vs CPU")
    check(p_err <= TOL_STEP["update"] * upd,
          f"fp32 step params: card vs CPU {p_err:.3e}, largest update {upd:.3e}")
    check(math.isfinite(m16["loss"]) and cos >= MIN_COS_GRAD_BF16,
          f"bf16 step: loss {m16['loss']}, gradient cosine {cos:.5f}")


# -- phase 10 ----------------------------------------------------------------


def _raport_losses_and_times(path: Path) -> tuple[list[float], list[float]]:
    losses, times = [], []
    for line in path.read_text().splitlines():
        rec = json.loads(line.split(" ", 1)[1])
        data = rec.get("data", {})
        if rec.get("type") == "LOG" and "train.loss" in data:
            losses.append(data["train.loss"])
            times.append(data["train.compute_time"])
    return losses, times


def phase_training() -> dict[str, int]:
    """``bert-pretrain`` through the CLI's runner on the card; returns the
    launches of the three runs (the training path)."""
    work = ROOT / "workspace" / "chip_smoke"
    eval_steps = 5  # the runner's val loader
    runs = [
        ("tree", 10, ["--batch-size", str(TB), "--seq-len", str(TS),
                      "--max-predictions", "20"]),
        ("flat", 10, ["--batch-size", str(TB), "--seq-len", str(TS),
                      "--max-predictions", "20", "--flat-lamb"]),
        ("phase2", 2, ["--batch-size", "8", "--phase2"]),
    ]
    total = dict.fromkeys(_counts(), 0)
    lines, curves = [], {}
    for name, steps, flags in runs:
        ws = work / name
        shutil.rmtree(ws, ignore_errors=True)
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()  # this training path starts here
        t0 = time.perf_counter()
        state, _ = cli(["bert-pretrain", "--bert-model", "large",
                        "--steps-per-epoch", str(steps), "--workspace", str(ws),
                        "--lr", PRETRAIN_LR, *flags])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = _counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check(state.step == steps, f"{name}: {state.step} steps, want {steps}")
        del state
        losses, times = _raport_losses_and_times(ws / "bert_pretrain_raport.json")
        shutil.rmtree(ws, ignore_errors=True)
        check(len(losses) == steps and all(math.isfinite(x) for x in losses),
              f"{name}: losses {losses}")
        check(losses[-1] < losses[0], f"{name}: loss did not fall: {losses}")
        curves[name] = losses
        flat_steps = steps if name == "flat" else 0
        want = {"flash_fwd": LAYERS * (steps + eval_steps),
                "flash_bwd_dq": LAYERS * steps, "flash_bwd_dkv": LAYERS * steps,
                "flat_lamb_moments": flat_steps, "flat_lamb_apply": flat_steps}
        check(launched == want, f"{name}: launches {launched}, want {want}")
        for k, v in launched.items():
            total[k] += v
        step_ms = statistics.median(times[1:]) * 1e3
        lines.append(f"{name} {steps} steps: loss "
                     + " ".join(f"{x:.4f}" for x in losses)
                     + f", median step {step_ms:.1f} ms, peak "
                     f"device memory {peak_gb:.2f} GB, run {wall:.1f} s; per "
                     f"step K1 {launched['flash_fwd'] // (steps + eval_steps)}"
                     f" (and {LAYERS} per eval batch), K2 "
                     f"{launched['flash_bwd_dq'] // steps}+"
                     f"{launched['flash_bwd_dkv'] // steps}, K3 "
                     f"{(launched['flat_lamb_moments'] + launched['flat_lamb_apply']) // steps}")
    shutil.rmtree(work, ignore_errors=True)
    second = (curves["tree"][1], curves["flat"][1])
    check(abs(second[0] - second[1]) <= TOL_TREE_FLAT * abs(second[0]),
          f"second-step loss: tree {second[0]} vs flat {second[1]}")
    say("10 training", f"bert-pretrain BERT-Large bf16, dropout 0.1, lr "
        f"{PRETRAIN_LR}, through the CLI: " + "; ".join(lines)
        + f"; second-step loss tree vs flat {abs(second[0] - second[1]):.2e} "
        "apart (step time: the loop's host clock per step, median after the "
        "first)")
    return total


def main() -> None:
    name = phase_device()
    phase_build()
    results = {"flash_fwd": phase_kernel()}
    fwd_err, bwd = phase_flash_bwd()
    results["flash_fwd"]["max_abs_err"] = max(
        results["flash_fwd"]["max_abs_err"], fwd_err)
    results.update(bwd)
    results.update(phase_flat_lamb())
    task, model = phase_slice()
    launched = dict.fromkeys(results, 0)
    launched["flash_fwd"] = phase_serving(task, model)  # counts set to 0 there
    launched["flash_fwd"] += phase_predict(task, model)
    check(_counts() == {**dict.fromkeys(results, 0),
                        "flash_fwd": launched["flash_fwd"]},
          "a launch count moved outside the serving path")
    check(launched["flash_fwd"] > 0, "the serving path never launched flash_fwd")
    del task, model
    phase_train_parity()
    for k, v in phase_training().items():  # counts set to 0 there
        launched[k] += v
    for k, v in launched.items():
        check(v > 0, f"the main path never launched {k}")
    sources = {
        "flash_fwd": ("csrc/flash_fwd.cu", "ops/flash_attention.py:686"),
        "flash_bwd_dq": ("csrc/flash_bwd.cu", "ops/flash_attention.py:896"),
        "flash_bwd_dkv": ("csrc/flash_bwd.cu", "ops/flash_attention.py:896"),
        "flat_lamb_moments": ("csrc/flat_lamb.cu", "core/flat.py:212"),
        "flat_lamb_apply": ("csrc/flat_lamb.cu", "core/flat.py:242"),
    }
    print(json.dumps({"kernels": [{
        "name": k,
        "route": "cuda",
        "source": f"deeplearningexamples_tpu_torch/{sources[k][0]}",
        "replaces": f"deeplearningexamples_tpu/{sources[k][1]}",
        "launches": launched[k],
        **{f: results[k][f] for f in ("max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms")},
    } for k in results]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
