"""A rank of the data-axis checks of the seventeen commands that PR 14 left on
one rank (``tests/test_torch_parallel_families.py``).

``python tests/torch_families_worker.py RANK WORLD PORT DIR`` joins a gloo
group of WORLD ranks at ``127.0.0.1:PORT`` through
``initialize_distributed``'s explicit arguments, runs every command through
the CLI at ``--mesh-data 2`` (and one at ``--mesh-data 1 --mesh-sequence
2``) at the small widths ``small_models`` patches in, then the three steps
the test holds against JAX on the inputs it writes to ``DIR/inputs.pt``
meanwhile, and writes what it recorded to ``DIR/rank{RANK}.pt``. It imports torch and the port only,
never JAX. The test runs the same commands, through the same functions, on
one rank in its own process.
"""

from __future__ import annotations

import functools
import os
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from deeplearningexamples_tpu_torch.cli import main as cli_main  # noqa: E402
from deeplearningexamples_tpu_torch.core import optimizers as opt  # noqa: E402
from deeplearningexamples_tpu_torch.core.train import (  # noqa: E402
    create_train_state, make_train_step,
)
from deeplearningexamples_tpu_torch.models import (  # noqa: E402
    asr, efficientdet, maskrcnn, moflow, ncf, se3_transformer, tft,
    transformer_xl, unet, wav2vec2,
)
from deeplearningexamples_tpu_torch.models import translation, tts  # noqa: E402
from deeplearningexamples_tpu_torch.models.translation import (  # noqa: E402
    gnmt, transformer as tr,
)
from deeplearningexamples_tpu_torch.models.tts import hifigan  # noqa: E402
from deeplearningexamples_tpu_torch.data import tts_synthetic  # noqa: E402
from deeplearningexamples_tpu_torch.parallel import mesh  # noqa: E402
from deeplearningexamples_tpu_torch.parallel.dist import (  # noqa: E402
    initialize_distributed,
)

B = 4  # the global batch of every run: 2 rows a rank
COMMANDS = ("tacotron2", "waveglow", "transformer", "bart", "gnmt",
            "fastpitch", "hifigan", "jasper", "wav2vec2", "ncf", "tft",
            "nnunet", "transformer-xl", "moflow", "se3-transformer",
            "efficientdet", "maskrcnn")
# each command's flags beyond the common ones: bart (summarize) and tft
# train on their data's batches, of which --prof takes the first two, then
# score the beam-decoded val split and the test split
FLAGS = {"efficientdet": ["--image-size", "128"],
         "maskrcnn": ["--image-size", "128"],
         "bart": ["--max-source-len", "32", "--max-target-len", "8",
                  "--beam-size", "2", "--prof", "2"],
         "tft": ["--prof", "2"]}
STEPS = 2
SEQUENCE_CASE = "transformer"  # the data 1 x sequence 2 run
TXL = "transformer-xl"  # written at world 2, resumed at world 1

# the small widths, dropout on wherever the model has it
T2 = dict(symbols_embedding_dim=32, encoder_embedding_dim=32,
          n_mel_channels=80, attention_rnn_dim=32, decoder_rnn_dim=32,
          prenet_dim=16, attention_dim=16, attention_location_n_filters=4,
          attention_location_kernel_size=7, postnet_embedding_dim=32,
          postnet_n_convolutions=3, max_decoder_steps=40)
WG = dict(n_flows=4, n_early_every=2, wn_n_layers=2, wn_n_channels=16)
NMT = dict(vocab_size=300, d_model=32, d_ff=64, num_heads=2,
           encoder_layers=1, decoder_layers=1, dropout=0.1, max_len=80)
GNMT = dict(vocab_size=300, hidden_size=16, num_layers=2, dropout=0.2)
FP = dict(n_symbols=32, d_model=32, n_heads=1, head_dim=16, encoder_layers=1,
          decoder_layers=1, conv_filters=48, n_mels=8, max_mel_len=40,
          predictor_filters=16, dropout=0.1, predictor_dropout=0.1,
          dropatt=0.1)
HIFI = dict(n_mels=8, upsample_rates=(4, 2), upsample_kernels=(8, 4),
            upsample_initial_channel=16, resblock_kernels=(3,),
            resblock_dilations=((1, 3),), periods=(2, 3), segment_length=640,
            hop_length=8, mpd_channels=(4, 8, 8), msd_channels=(4, 8, 16, 16),
            msd_scales=2)
W2V = dict(conv_layers=((16, 10, 5), (16, 3, 2), (16, 3, 2), (16, 3, 2),
                        (16, 3, 2), (16, 2, 2), (16, 2, 2)),
           d_model=32, n_heads=2, n_layers=1, d_ff=64, dropout=0.1,
           conv_pos=16, conv_pos_groups=4, n_groups=2, n_entries=8,
           codevector_dim=16, mask_span=2, n_negatives=5)
NCF = dict(nb_users=50, nb_items=40, mf_dim=8, mlp_layer_sizes=(16, 16, 8, 4),
           dropout=0.5)
TFT = dict(hidden=8, n_heads=2)
UNET = dict(base_filters=4, depth=2, max_filters=8)
TXL_CFG = dict(vocab_size=100, d_model=16, n_heads=2, d_head=8, d_ff=32,
               n_layers=2, seg_len=6, mem_len=8, dropout=0.1)
MOFLOW = dict(n_node=6, n_atom_types=4, n_bond_types=4, bond_n_flow=2,
              bond_squeeze=3, bond_hidden=(8,), atom_n_flow=2,
              atom_hidden_gnn=(8,), atom_hidden_lin=(8, 6))
SE3 = dict(num_layers=1, num_degrees=2, num_channels=8, num_heads=2)
DET = dict(fpn_width=16, fpn_depth=1, head_depth=1)
# more ROI slots than proposals: each image's live slots differ
MRCNN = dict(backbone="resnet18", num_classes=6, fpn_width=16,
             head_fc_dim=32, rpn_pre_nms_top_n=100, rpn_post_nms_top_n=16,
             rpn_batch_per_image=32, roi_batch_per_image=64)


def _forced(cls, **small):
    """``cls`` whose ``small`` fields win over the caller's."""
    return lambda *a, **kw: cls(*a, **{**kw, **small})


def pinned_proposals(self, logits, deltas):
    """Mask R-CNN's proposals pinned to a spread of P2's anchors, the same
    for every image: a proposal decodes through ``exp`` of the RPN's
    deltas, so a rounding of the backbone's sums moves its corners by about
    1e-3 px, and the heads' gradients by 1e-3 of theirs, between any two
    runs. The RPN's loss still reads the RPN's outputs."""
    anchors = self.anchors(logits[0].device)[0]
    n, b = self.cfg.rpn_post_nms_top_n, logits[0].shape[0]
    idx = torch.arange(n, device=anchors.device) * (anchors.shape[0] // n)
    boxes = anchors[idx].float().clamp(0.0, self.cfg.image_size)
    return (boxes[None].expand(b, n, 4).contiguous(),
            torch.ones(b, n, dtype=torch.bool, device=anchors.device))


def small_models(mp: pytest.MonkeyPatch) -> None:
    """The commands' models at the small widths above (the CLI's builders
    import their config and task classes from these modules when they
    run), Tacotron2's synthetic text of 16 and mels of 24 frames, Mask
    R-CNN's proposals pinned (``pinned_proposals``)."""
    t2_cls, wg_cls = tts.Tacotron2Task, tts.WaveGlowTask
    mp.setattr(tts, "Tacotron2Task", lambda dtype: t2_cls(
        tts.Tacotron2Config(**T2), dtype))
    mp.setattr(tts, "WaveGlowTask", lambda dtype: wg_cls(
        tts.WaveGlowConfig(**WG), dtype))
    mp.setattr(tts_synthetic, "SyntheticTacotronLoader", functools.partial(
        tts_synthetic.SyntheticTacotronLoader, max_text_len=16,
        max_mel_len=24))
    mp.setattr(translation, "TransformerConfig",
               lambda **kw: tr.TransformerConfig(**{
                   **NMT, **kw, **{k: v for k, v in NMT.items()
                                   if k not in ("vocab_size", "max_len")}}))
    mp.setattr(gnmt, "GnmtTask", functools.partial(
        gnmt.GnmtTask, gnmt.GnmtConfig(**GNMT)))
    fp_cls, hifi_cls = tts.FastPitchTask, tts.HiFiGanTask
    mp.setattr(tts, "FastPitchTask", lambda dtype: fp_cls(
        tts.FastPitchConfig(**FP), dtype))
    mp.setattr(tts, "HiFiGanTask", lambda dtype: hifi_cls(
        tts.HiFiGanConfig(**HIFI), dtype))
    jasper = asr.JasperConfig(n_mels=64, vocab_size=29, blocks=(
        asr.JasperBlock(1, 16, 11, 0.2, residual=False, stride=2),
        asr.JasperBlock(2, 16, 11, 0.2),
        asr.JasperBlock(1, 32, 1, 0.2, residual=False)))
    jasper_cls, w2v_cls = asr.JasperTask, wav2vec2.Wav2Vec2Task
    mp.setattr(asr, "JasperTask", lambda dtype: jasper_cls(jasper, dtype))
    mp.setattr(wav2vec2, "Wav2Vec2Task", lambda dtype: w2v_cls(
        wav2vec2.Wav2Vec2Config(**W2V), dtype))
    mp.setattr(ncf, "NcfConfig", _forced(ncf.NcfConfig, **NCF))
    mp.setattr(tft, "TFTConfig", _forced(tft.TFTConfig, **TFT))
    mp.setattr(unet, "UNetConfig", _forced(unet.UNetConfig, **UNET))
    txl_cls = transformer_xl.TransformerXLTask
    mp.setattr(transformer_xl, "TransformerXLTask", lambda dtype: txl_cls(
        transformer_xl.TransformerXLConfig(**TXL_CFG), dtype))
    mp.setattr(moflow, "MoFlowConfig", _forced(moflow.MoFlowConfig, **MOFLOW))
    mp.setattr(se3_transformer, "SE3Config",
               _forced(se3_transformer.SE3Config, **SE3))
    mp.setattr(efficientdet, "EfficientDetConfig",
               _forced(efficientdet.EfficientDetConfig, **DET))
    mp.setattr(maskrcnn, "MaskRCNNConfig",
               _forced(maskrcnn.MaskRCNNConfig, **MRCNN))
    mp.setattr(maskrcnn.MaskRCNNTask, "proposals", pinned_proposals)


def args(command: str, workspace: str, *extra: str) -> list[str]:
    return [command, "--device", "cpu", "--amp", "false", "--batch-size",
            str(B), "--steps-per-epoch", str(STEPS), "--lr", "1e-3",
            "--workspace", workspace, *FLAGS.get(command, []), *extra]


def _named(module: torch.nn.Module) -> tuple[dict, dict]:
    """(parameters, BN running statistics), detached copies."""
    return ({n: p.detach().clone() for n, p in module.named_parameters()},
            {n: b.detach().clone() for n, b in module.named_buffers()
             if ".running_" in n or n.startswith("running_")})


def run_command(argv: list[str]) -> dict:
    """The CLI on ``argv``, recording each step's loss, the first step's
    gradients (after the data axis's mean) and BN running statistics (both
    at the parameters every run starts from: Adam moves a parameter whose
    gradient is 0 but for rounding, a bias before a BN, by the rate in
    either direction), and the parameters and eval metrics at the end."""
    rec: dict = {"losses": [], "grads": None}
    real_loop, real_grads = cli_main.train_loop, hifigan.HiFiGanTask.grads

    def loop(state, train_step, *a, **kw):
        def step(state, batch):
            state, m = train_step(state, batch)
            rec["losses"].append(float(m["loss"]))
            if rec["grads"] is None:
                rec["grads"] = {n: p.grad.detach().clone() for n, p in
                                state.model.named_parameters()
                                if p.grad is not None}
                rec["stats"] = _named(state.model)[1]
            return state, m
        return real_loop(state, step, *a, **kw)

    def hifigan_grads(model, loss):
        g = real_grads(model, loss)
        if len(rec.setdefault("gan_grads", [])) < 2:  # d_step's, g_step's
            rec["gan_grads"].append({n: t.clone() for n, t in g.items()})
        return g

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli_main, "train_loop", loop)
        mp.setattr(hifigan.HiFiGanTask, "grads", staticmethod(hifigan_grads))
        out = cli_main.cli(argv)
    if argv[0] == "hifigan":
        gen, disc, metrics = out
        d_grads, g_grads = rec.pop("gan_grads")
        rec["grads"] = {**{f"disc.{n}": t for n, t in d_grads.items()},
                        **{f"gen.{n}": t for n, t in g_grads.items()}}
        rec["losses"] = [metrics["train.d_loss"], metrics["train.g_loss"]]
        rec["metrics"] = metrics
        p_gen, _ = _named(gen)
        p_disc, _ = _named(disc)
        rec["params"] = {**{f"gen.{n}": t for n, t in p_gen.items()},
                         **{f"disc.{n}": t for n, t in p_disc.items()}}
        rec["stats"] = {}
        return rec
    state = out[0]
    rec["params"] = _named(state.model)[0]
    rec["metrics"] = {}
    if argv[0] == "bart":
        rec["metrics"] = out[1]
    elif argv[0] == "tft":
        rec["metrics"] = out[2]
    if argv[0] == TXL:
        rec["mems"] = [m.detach().clone() for m in state.model_state["mems"]]
    return rec


# -- the steps held against JAX: one step at rate 0 on the global batch -------


def held_step(task, model: torch.nn.Module, batch: dict,
              model_state=None) -> dict:
    """One SGD step at rate 0 on this rank's rows of the global ``batch``:
    the loss and metrics (means over the data axis) and the gradients after
    the data axis's mean."""
    tx = opt.sgd(0.0, 0.0)
    state = create_train_state(model, tx, 1, model_state=model_state)
    step = make_train_step(task.loss_fn, tx)
    state, m = step(state, mesh.shard_batch(
        {k: torch.as_tensor(v) for k, v in batch.items()}))
    return {"metrics": {k: float(v) for k, v in m.items()},
            "grads": {n: p.grad.detach().clone()
                      for n, p in model.named_parameters()
                      if p.grad is not None}}


def _load(model: torch.nn.Module, sd: dict) -> torch.nn.Module:
    model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()},
                          strict=False)
    return model


def held_runs(inp: dict) -> dict:
    """The Transformer NMT, wav2vec 2.0 (JAX's draws of the global batch
    handed to each rank, which keeps its rows) and EfficientDet (eval-mode
    BN) on JAX's weights."""
    out = {}
    t = inp["transformer"]
    model = _load(tr.Transformer(tr.TransformerConfig(**t["cfg"]),
                                 torch.float32), t["sd"])
    out["transformer"] = held_step(
        tr.TransformerTask(model.cfg, torch.float32), model, t["batch"])

    w = inp["wav2vec2"]
    cfg = wav2vec2.Wav2Vec2Config(**w["cfg"])
    task = wav2vec2.Wav2Vec2Task(cfg, torch.float32)
    draws = {k: torch.as_tensor(v) for k, v in w["draws"].items()}
    task.draws = lambda g, b, t, dev: {
        k: mesh.draw_rows(lambda rows, v=v: v, b) for k, v in draws.items()}
    model = _load(wav2vec2.Wav2Vec2(cfg, torch.float32), w["sd"])
    out["wav2vec2"] = held_step(task, model, w["batch"])

    e = inp["efficientdet"]
    ecfg = efficientdet.EfficientDetConfig(**e["cfg"])
    task = efficientdet.EfficientDetTask(ecfg, torch.float32, max_gt=e["g"])
    model = _load(efficientdet.EfficientDet(ecfg, torch.float32), e["sd"])
    model.eval()
    out["efficientdet"] = held_step(task, model, e["batch"],
                                    task.model_state(model))
    return out


def _inputs(out_dir: str, timeout: float = 120.0) -> dict:
    """``DIR/inputs.pt``, which the test writes (whole, by a rename) while
    the ranks run the commands."""
    path = os.path.join(out_dir, "inputs.pt")
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path} after {timeout} s")
        time.sleep(0.05)
    return torch.load(path, weights_only=False)


def main(rank: int, world: int, port: int, out_dir: str) -> None:
    torch.set_num_threads(1)
    initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    res: dict = {}
    with pytest.MonkeyPatch.context() as mp:
        small_models(mp)
        for command in COMMANDS:
            res[command] = run_command(args(
                command, os.path.join(out_dir, f"{command}_{rank}"),
                "--mesh-data", "2"))
        res["sequence"] = run_command(args(
            SEQUENCE_CASE, os.path.join(out_dir, f"sequence_{rank}"),
            "--mesh-data", "1", "--mesh-sequence", "2"))
    mesh.build_mesh(mesh.MeshSpec(data=2))
    res["held"] = held_runs(_inputs(out_dir))
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
