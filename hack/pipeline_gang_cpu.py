"""A CPU rehearsal of ``chip_smoke.py``'s ``pipeline_1f1b_moe`` and
``pipeline_1f1b_gang`` phases at a small width, for a host without a
card:

    python3 hack/pipeline_gang_cpu.py

The flagship and the MoE flagship shrink to width 64 (vocab 256,
max_seq 1024), the train batch to 16 x 64, every mesh position is the
CPU, and the launch checks are off (CPU tensors launch no kernel). The
one-process ``data=2 x pipeline=2`` row the gang is held to comes from
``train_1f1b`` here. The gang's two ranks re-enter through this file.
Each phase prints its JSON row; ~25 s with ``OMP_NUM_THREADS=1``.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from kubeflow_tpu_torch.compute.models import transformer  # noqa: E402

cs.CARD = "cpu"
cs.TRAIN_BATCH = (16, 64)
cs.check_mesh_launches = lambda *args: None
cs.__file__ = __file__
torch.cuda.synchronize = lambda *args: None
torch.cuda.empty_cache = lambda *args: None


def flagship_config(dtype="bfloat16", attention="flash", **kw):
    fields = dict(vocab_size=256, d_model=64, n_layers=12, n_heads=4,
                  n_kv_heads=2, max_seq=1024)
    return transformer.Config(**{**fields, **kw}, dtype=dtype,
                              attention=attention)


def moe_config(dtype="bfloat16", **kw):
    fields = dict(vocab_size=256, d_model=64, n_layers=8, n_heads=4,
                  max_seq=1024, moe_experts=8, moe_top_k=2,
                  moe_dropless=True, moe_gmm="auto", moe_gmm_block_m=16,
                  scan_layers=False, remat=False, attention="flash")
    return transformer.Config(**{**fields, **kw}, dtype=dtype)


cs.flagship_config, cs.moe_config = flagship_config, moe_config


def main():
    from kubeflow_tpu_torch.compute import data, mesh as mesh_lib
    from kubeflow_tpu_torch.compute import pipeline, sharding
    fns = cs.counted_kernels()
    cs.phase_pipeline_1f1b_moe(fns)
    cfg = flagship_config(remat=False, pipeline_stages=2,
                          pipeline_microbatches=cs.F1B_MICRO)
    mesh = mesh_lib.make_mesh(data=2, pipeline=2, devices=["cpu"] * 4)
    B, S = cs.TRAIN_BATCH
    host = next(data.synthetic_lm(B, S, cfg.vocab_size, seed=4))
    params = cs._1f1b_params(sharding.place_tree(
        transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu"),
        mesh, transformer.logical_axes(cfg)))
    loss, _ = pipeline.train_1f1b(
        *cs.flagship_1f1b_fns(cfg), params,
        torch.from_numpy(host["tokens"]), torch.from_numpy(host["targets"]),
        cs.F1B_MICRO, mesh)
    cs.phase_pipeline_1f1b_gang({"1f1b": {"loss": float(loss), "ms": 1.0}},
                                list(fns))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--pipeline-1f1b-gang-rank"]:
        cs.main()
    else:
        main()
