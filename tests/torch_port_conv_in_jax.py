"""JAX's side of sgam_neurips22_tpu_torch/studies/conv_in_witness.py, which
imports no JAX: for each seed, the JAX TINY conditional training state
(flash attention on) before step 1, and for each of the study's cases
(batch, LPIPS, compute dtype) the state after step 1 and conv_in.bias's
Adam first moment after steps 1 and 2 of the JAX `train_step`, on the
study's batches; numpy leaves, one pickle.

    python tests/torch_port_conv_in_jax.py --out W.pkl [--seeds 0 1 2 3] [--batches 2 8]

From the repository root, on the CPU.
"""
import argparse
import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from sgam_neurips22_tpu.models import DDConfig, VQModelConfig  # noqa: E402
from sgam_neurips22_tpu.training.losses import LossConfig  # noqa: E402
from sgam_neurips22_tpu.training.lpips import init_lpips  # noqa: E402
from sgam_neurips22_tpu.training.train_step import TrainConfig, create_train_state, train_step  # noqa: E402
from sgam_neurips22_tpu_torch.core.state_dict import from_jax_params  # noqa: E402
from sgam_neurips22_tpu_torch.studies import conv_in_witness as study  # noqa: E402

TREES = ("params", "disc_params", "disc_state")


def numpy_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x), tree)


def jax_config(lpips: bool, dtype: str) -> TrainConfig:
    model = VQModelConfig(ddconfig=DDConfig(**study.DDCONFIG, compute_dtype=dtype), **study.MODEL)
    return TrainConfig(model=model, loss=LossConfig(**study.LOSS, perceptual_weight=1.0 if lpips else 0.0),
                       learning_rate=study.LR)


def moment(state) -> np.ndarray:
    return from_jax_params(numpy_tree(state["opt_ae"][0].mu))[study.TENSOR]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--batches", type=int, nargs="+", default=[2, 8])
    args = ap.parse_args(argv)
    lpips_params = init_lpips(jax.random.PRNGKey(42))
    rec = {"seeds": args.seeds, "lpips": numpy_tree(lpips_params), "init": {}, "cases": {}}
    for seed in args.seeds:
        init = create_train_state(jax.random.PRNGKey(seed), jax_config(False, "float32"))
        rec["init"][seed] = {k: numpy_tree(init[k]) for k in TREES}
        for b, lpips, dtype in study.CASES:
            if b not in args.batches:
                continue
            cfg = jax_config(lpips, dtype)
            state = jax.tree_util.tree_map(lambda x: x.copy(), init)  # train_step donates its state
            batch = {k: jax.numpy.asarray(v) for k, v in study.cond_batch(b, seed).items()}
            lp = lpips_params if lpips else None
            state, _ = train_step(state, batch, lp, cfg)
            case = {"moment1": moment(state), "after1": {k: numpy_tree(state[k]) for k in TREES}}
            state, _ = train_step(state, batch, lp, cfg)
            case["moment2"] = moment(state)
            rec["cases"][study.case_key(seed, b, lpips, dtype)] = case
            print(study.case_key(seed, b, lpips, dtype), case["moment1"], case["moment2"], flush=True)
    with open(args.out, "wb") as f:
        pickle.dump(rec, f)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
