"""The ranks of tests/test_torch_port_parallel.py: module-level functions
that `parallel.distributed.launch` runs in spawned gloo processes on the
CPU. This module imports torch, numpy and the port only, never JAX: each
rank reads its inputs from a file the test wrote and writes its results
to another."""
import copy
import os
import sys

import numpy as np
import torch

from sgam_neurips22_tpu_torch.parallel import distributed
from sgam_neurips22_tpu_torch.parallel.mesh import batch_sharding, make_mesh, shard_batch
from sgam_neurips22_tpu_torch.studies.data_parallel import planted

REFRESH_SEED = 7  # rank r draws its k-means init rows from seed REFRESH_SEED + r


def _rank_file(out_dir: str, name: str) -> str:
    return os.path.join(out_dir, f"{name}_rank{distributed.process_index()}.pt")


def primitives(out_dir: str) -> None:
    """replicate_global, shard_local_batch, the bucketed mean, the gather,
    the differentiable sum and the mesh, each on rank-dependent values."""
    assert "jax" not in sys.modules
    mesh = make_mesh(device="cpu")
    rank, n = mesh.rank, mesh.size
    out = {"size": n, "rank": rank, "local_rank": distributed.local_rank()}
    tree = {"w": torch.full((3, 2), float(rank + 1)), "b": [torch.arange(4) * (rank + 1)]}
    out["replicated"] = distributed.replicate_global(tree, mesh)
    global_batch = {"x": np.arange(8 * 3, dtype=np.float32).reshape(8, 3)}
    local = {k: v[rank * 8 // n: (rank + 1) * 8 // n] for k, v in global_batch.items()}
    out["local_batch"] = distributed.shard_local_batch(local, mesh)["x"]
    out["shard_batch"] = shard_batch(global_batch, mesh)["x"]
    out["batch_sharding"] = batch_sharding(mesh).local(global_batch["x"])
    # three buckets: two f32 runs split by the bucket size, one f64 run
    grads = [torch.full((5,), float(rank)), torch.full((7, 2), 10.0 * rank),
             torch.tensor([rank, 2.0 * rank], dtype=torch.float64)]
    distributed.all_reduce_mean_(grads, mesh.group, bucket_bytes=5 * 4)
    out["mean"] = grads
    out["gathered"] = distributed.all_gather_rows(torch.full((2, 3), float(rank)), mesh.group)
    x = torch.tensor([1.0, 2.0], requires_grad=True) * (rank + 1)
    total = distributed.all_reduce_sum(x, mesh.group)
    (grad,) = torch.autograd.grad((total * (rank + 1)).sum(), x)
    out["sum"], out["sum_grad"] = total.detach(), grad
    out["name"] = distributed.broadcast_object(f"run-of-rank-{rank}")
    try:
        make_mesh(n + 1, device="cpu")
        out["wrong_n_devices"] = None
    except ValueError as e:
        out["wrong_n_devices"] = str(e)
    torch.save(out, _rank_file(out_dir, "primitives"))


def _state_record(state, logs) -> dict:
    return {
        "logs": {k: float(v) for k, v in logs.items()},
        "model": {k: v.clone() for k, v in state.model.state_dict().items()},
        "disc": {k: v.clone() for k, v in state.disc.state_dict().items()},
        "opt_ae": copy.deepcopy(state.opt_ae.state_dict()), "opt_disc": copy.deepcopy(state.opt_disc.state_dict()),
        "step": state.step,
        "kmeans": None if state.kmeans is None else
        {"timeout": state.kmeans.timeout.clone(), "buffer": state.kmeans.buffer.clone(), "ptr": state.kmeans.ptr},
        "accumulators": None if state.accumulators is None else copy.deepcopy([a.state_dict() for a in
                                                                               state.accumulators]),
    }


def train_steps(spec_path: str, out_dir: str) -> None:
    """Each scenario of the spec: this rank's rows of the global batch
    through the port's train_step, from the spec's weights; after each step
    the state, and (`carry`) the next step's weights loaded as the spec
    gives them; a k-means refresh at the end where the spec asks for one."""
    assert "jax" not in sys.modules
    from sgam_neurips22_tpu_torch.training.kmeans import refresh_codebook
    from sgam_neurips22_tpu_torch.training.lpips import LPIPS
    from sgam_neurips22_tpu_torch.training.train_step import create_train_state, train_step

    spec = torch.load(spec_path, weights_only=False)
    mesh = make_mesh(device="cpu")
    results = {}
    for name, sc in spec.items():
        cfg = sc["cfg"]
        state = create_train_state(cfg, seed=0, device="cpu")
        state.model.load_state_dict(sc["model"])
        state.disc.load_state_dict(sc["disc"])
        lp = LPIPS()
        lp.load_state_dict(sc["lpips"])
        batch = shard_batch({k: torch.as_tensor(v) for k, v in sc["batch"].items()}, mesh)
        records = []
        with planted(sc.get("fault")):
            for step, carry in enumerate(sc["carry"]):
                state, logs = train_step(state, batch, lp, cfg)
                records.append(_state_record(state, logs))
                if carry is not None:
                    state.model.load_state_dict(carry["model"])
                    state.disc.load_state_dict(carry["disc"])
        if sc.get("refresh"):
            km = cfg.online_kmeans
            state.kmeans.timeout[: sc["refresh"]] = 0  # the same inactive rows on every rank
            k = refresh_codebook(state.model.codebook, state.kmeans, km.online_kmeans_word_timeout,
                                 torch.Generator().manual_seed(REFRESH_SEED + mesh.rank))
            records.append({"refreshed": k, "codebook": state.model.codebook.detach().clone(),
                            "timeout": state.kmeans.timeout.clone()})
        results[name] = records
    torch.save(results, _rank_file(out_dir, "train"))


class IndexDataset:
    """Its index and one draw of the example's own stream (picklable, for
    worker processes)."""

    def __init__(self, n: int):
        self.n = n

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i, rng=None):
        r = rng.integers(0, 1 << 30) if rng is not None else -1
        return {"idx": np.int64(i), "draw": np.int64(r)}


def scenes(spec_path: str, out_dir: str) -> None:
    """scene_expansion_batched over the ranks' mesh for each case of the
    spec: (rgb, depth, the batched volume's stats)."""
    assert "jax" not in sys.modules
    import warnings

    from sgam_neurips22_tpu_torch.models.vqgan.model import VQModel
    from sgam_neurips22_tpu_torch.pipeline.scene_generation import InfiniteSceneGeneration

    spec = torch.load(spec_path, weights_only=False)
    mesh = make_mesh(device="cpu")
    out = {}
    for name, case in spec.items():
        model = VQModel(case["model_cfg"])
        model.load_state_dict(case["weights"])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            gen = InfiniteSceneGeneration(model.eval(), case["cfg"], case["seeds"][0], intrinsics=case["K"],
                                          device="cpu")
        if case.get("identity"):
            gen.model = Identity()
        generator = torch.Generator().manual_seed(case["seed"]) if case.get("seed") is not None else None
        try:
            rgb, depth = gen.scene_expansion_batched(case["seeds"], generator, mesh=mesh)
        except ValueError as e:  # a scene count that does not divide
            out[name] = {"error": str(e)}
            continue
        vol = gen.batched_volume
        out[name] = {"rgb": rgb.clone(), "depth": depth.clone(),
                     "stats": None if vol is None else vol.stats.clone(),
                     "volume": None if vol is None else {f: getattr(vol, f).clone() for f in case.get("fields", ())}}
    torch.save(out, _rank_file(out_dir, "scenes"))


class Identity(torch.nn.Module):
    """The model stand-in of the bit-exact map test: xrec = its input."""

    def forward(self, x, **kw):
        from types import SimpleNamespace

        return SimpleNamespace(xrec=x[:, None])


def emergency(spec_path: str) -> None:
    """A Trainer on every rank: two fit steps, then an emergency checkpoint
    at a later step (rank 0 writes it), then a fresh Trainer that resumes;
    writes the resumed step and the checkpoint steps each rank sees."""
    assert "jax" not in sys.modules
    from sgam_neurips22_tpu_torch.core.config import wrap
    from sgam_neurips22_tpu_torch.training.trainer import Trainer

    spec = torch.load(spec_path, weights_only=False)
    kw = dict(use_wandb=False, device="cpu", install_signals=False, max_steps=1)
    tr = Trainer(wrap(spec["cfg"]), spec["logdir"], **kw)
    tr.fit()
    tr.state.step = spec["step"]  # progress past the latest checkpoint
    tr._emergency_save()
    tr.close()
    distributed.barrier()
    again = Trainer(wrap(spec["cfg"]), spec["logdir"], **kw)
    again.resume()
    torch.save({"resumed": again.state.step, "checkpoints": again.ckpt.all_steps(),
                "codebook": again.state.model.codebook.detach().clone()},
               os.path.join(spec["logdir"], f"emergency_rank{distributed.process_index()}.pt"))
    again.close()
