"""One rank of tests/test_torch_distributed.py's process group, on the CPU.

    python -m torch.distributed.run --standalone --nproc_per_node 2 \
        tests/torch_dist_worker.py INPUTS OUT ROOT

INPUTS (written by the test) holds the tiny config, the port's weights, the
LPIPS parameters, a global batch of 2 and each item's injected sample
points. Each rank, over gloo:
  1. the data-parallel train step on its slice (``Pipeline.train_step`` with
     injected points), the averaged gradients recorded before the update;
     then the same step from the same state with the model computing in
     bf16 (``set_compute_dtype``);
  2. the ZeRO-1 step (``trainer.zero1``) from the same state on the same slice;
  3. the data-parallel eval step on its slice, gathered on rank 0, which
     also runs the one-process eval step on the whole batch;
  4. ``cli/validate`` on ROOT (two val pairs: one batch of 2);
  5. ``cli/train`` on ROOT with ``trainer.zero1`` and two micro-steps an
     optimizer step, a checkpoint each epoch (the first mid-accumulation),
     then ``--resume`` of that checkpoint.
Rank 0 writes OUT/results.pt; every rank writes OUT/rank{r}.pt.
Imports nothing of JAX.
"""

import os
import sys
from pathlib import Path

import torch

from siu3r_tpu_torch import config as port_config
from siu3r_tpu_torch import parallel
from siu3r_tpu_torch.cli import train, validate
from siu3r_tpu_torch.models.model import set_compute_dtype
from siu3r_tpu_torch.pipeline import EVAL_KEYS, Pipeline, gather_eval_arrays
from siu3r_tpu_torch.train.optimizer import Zero1AdamW3
from siu3r_tpu_torch.visualizer import eval_step_arrays


def _bn_stats(model):
    return {k: v.clone() for k, v in model.state_dict().items() if k.endswith(("running_mean", "running_var"))}


def main(inputs: str, out: str, root: str) -> None:
    torch.set_num_threads(2)
    parallel.init_distributed("gloo", "cpu")
    rank = parallel.rank()
    out = Path(out)
    inp = torch.load(inputs, weights_only=False)
    cfg = port_config._from_dict(port_config.RootCfg, inp["cfg"])
    pipe = Pipeline(cfg, device="cpu", seed=0).init_train(steps_per_epoch=10)
    pipe.model.load_state_dict(inp["state"])
    pipe.lpips_params = inp["lpips"]
    initial = {k: v.clone() for k, v in pipe.model.state_dict().items()}
    batch = {k: torch.from_numpy(v) for k, v in parallel.shard_batch(inp["batch"]).items()}
    injected = [{k: torch.from_numpy(v) for k, v in parallel.shard_batch(d).items()} for d in inp["injected"]]
    params = dict(pipe.model.named_parameters())
    res, mine = {}, {}

    # 1. the data-parallel step, its averaged gradients recorded
    grads = {}
    step = pipe.optimizer.step

    def recording_step():
        grads.update({n: p.grad.clone() for n, p in params.items()})
        return step()

    pipe.optimizer.step = recording_step
    res["dp_losses"] = {k: float(v) for k, v in pipe.train_step(batch, None, injected_coords=injected).items()}
    del pipe.optimizer.step
    dp_params = {n: p.detach().clone() for n, p in params.items()}
    res["dp_grads"], res["dp_stats"] = grads, _bn_stats(pipe.model)
    mine["dp_params_sum"] = float(sum(p.double().sum() for p in dp_params.values()))

    # 1b. the same step computing in bf16, from the same state (the
    #     optimizer's moments have moved: only gradients, terms and
    #     statistics are recorded)
    pipe.model.load_state_dict(initial)
    set_compute_dtype(pipe.model, "bfloat16")
    grads = {}
    pipe.optimizer.step = recording_step
    res["bf16_losses"] = {k: float(v) for k, v in pipe.train_step(batch, None, injected_coords=injected).items()}
    del pipe.optimizer.step
    res["bf16_grads"], res["bf16_stats"] = grads, _bn_stats(pipe.model)
    set_compute_dtype(pipe.model, "float32")

    # 2. ZeRO-1 from the same state, on the same slice
    pipe.model.load_state_dict(initial)
    cfg.trainer.zero1 = True
    pipe.init_train(steps_per_epoch=10)
    pipe.lpips_params = inp["lpips"]
    assert isinstance(pipe.optimizer, Zero1AdamW3)
    res["z1_losses"] = {k: float(v) for k, v in pipe.train_step(batch, None, injected_coords=injected).items()}
    res["z1_minus_dp"] = {n: float((p.detach() - dp_params[n]).abs().max()) for n, p in params.items()}
    res["dp_moved"] = {n: float((dp_params[n] - initial[n]).abs().max()) for n in params}
    mine["moment_sizes"] = {g: (t.numel(), pipe.optimizer.nu[g].numel()) for g, t in pipe.optimizer.mu.items()}
    mine["group_sizes"] = {g: sum(params[n].numel() for n in names) for g, names in pipe.optimizer.groups.items()}
    mine["z1_params_sum"] = float(sum(p.detach().double().sum() for p in params.values()))

    # 3. the data-parallel eval step, and on rank 0 the one-process one
    pipe.model.load_state_dict(initial)
    m2f = cfg.pipeline.model.mask2former
    full = {k: torch.from_numpy(inp["batch"][k]) for k in EVAL_KEYS}
    arrays = gather_eval_arrays(eval_step_arrays(*pipe.eval_step(parallel.shard_batch(full)), m2f))
    if rank == 0:
        res["dp_eval"] = arrays
        res["one_eval"] = eval_step_arrays(*pipe.eval_step(full), m2f)
    del pipe, params, initial, grads, dp_params

    # 4. the validation sweep
    cli = ["--config", os.devnull, "--device", "cpu", "--dist_backend", "gloo"]
    tiny = inp["overrides"] + [f"datamodule.dataset_cfg.root={root}"]
    res["validate"] = validate.main(cli + ["--ckpt", inp["sweep_weights"], "--output_path", str(out / "val"), *tiny])

    # 5. the training entry point, then its resume mid-accumulation
    train_args = [*tiny, "datamodule.train_loader_cfg.batch_size=2", "trainer.zero1=true", "trainer.max_epochs=4",
                  "trainer.accumulate_grad_batches=2", "trainer.max_steps=2", "pipeline.log_training_result_interval=2"]
    res["train"] = train.main(cli + [f"output_path={out / 'train'}", *train_args])
    res["resumed"] = train.main(cli + ["--resume", str(out / "train" / "checkpoints" / "epoch000-1"),
                                       f"output_path={out / 'resumed'}", *train_args])
    torch.save(mine, out / f"rank{rank}.pt")
    if rank == 0:
        torch.save(res, out / "results.pt")
    parallel.barrier()
    parallel.shutdown()


if __name__ == "__main__":
    main(*sys.argv[1:])
