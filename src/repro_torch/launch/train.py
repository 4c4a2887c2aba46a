"""Training launcher on the card.

    python -m repro_torch.launch.train --arch llama3.2-3b [--smoke] [--steps N]
                                       [--mesh-devices 8] [--ckpt DIR]
                                       [--device cpu]

The port of ``repro/launch/train.py``: the same flags and defaults, and
``--device`` (the card by default; ``cpu`` runs the plain path).
``--smoke`` (the default) takes the reduced same-family config; ``--full``
the arch's own.  Either runs the fault-tolerant driver
(``runtime.driver.train_loop``: auto-resume, async atomic checkpoints,
non-finite step count, straggler deadline) over the synthetic bigram
stream, read from the pipeline's prefetch thread (started at the driver's
first step, joined when the run ends), and prints one ``[train] done``
line.

``--mesh-devices N`` trains through the sharded step
(``runtime.steps.shard_train_step``) on a ``(max(N // 4, 1), min(4, N))``
data x model mesh of ranks on ``--device`` (on one card every rank is
``cuda:0``; on the CPU every rank is ``cpu``), as the JAX launcher builds
its test mesh; ``put_batch`` lays each batch over the data ranks.  Its
checkpoints hold the whole arrays, so a run resumes on any mesh.
"""

from __future__ import annotations

import argparse
import os
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--mesh-devices", type=int, default=0)
    ap.add_argument("--ckpt", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain path)")
    args = ap.parse_args(argv)

    import torch

    from ..configs import get_config, smoke_config
    from ..configs.base import ShapeConfig
    from ..data.pipeline import SyntheticPipeline
    from ..kernels import dispatch
    from ..models import get_model
    from ..optim import adamw
    from ..runtime import steps as rt
    from ..runtime.driver import DriverConfig, train_loop

    dev = dispatch.resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    shape = ShapeConfig("train", args.seq_len, args.batch, "train")
    api = get_model(cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(0))
    opt_cfg = adamw.OptConfig(lr=args.lr,
                              warmup_steps=min(20, args.steps // 5),
                              total_steps=args.steps)
    put_batch = None
    if args.mesh_devices:
        from ..launch import specs
        from ..launch.mesh import make_pod_mesh
        from ..sharding import rules
        n = args.mesh_devices
        mesh = make_pod_mesh((max(n // 4, 1), min(4, n)), dev)
        step, pspec, _, bspec = rt.shard_train_step(
            api, cfg, opt_cfg, mesh, shape, params,
            specs.batch_specs(cfg, shape))
        params = rt.shard_params(params, pspec, mesh)
        opt_state = adamw.init_sharded(opt_cfg, params)

        def put_batch(b):
            return rules.shard_tree(b, bspec, mesh)
        print(f"[train] sharded step on {mesh.shape} mesh")
    else:
        opt_state = adamw.init(opt_cfg, dict(params.named_parameters()))
        step = rt.make_train_step(api, cfg, opt_cfg)

    pipe = SyntheticPipeline(cfg, shape, seed=0)
    stream = None

    def get_batch(i):
        # the driver asks for consecutive steps from its first (0 or the
        # resumed one): the prefetched stream starts there
        nonlocal stream
        if stream is None:
            stream = iter(pipe.start(i))
        return {k: torch.as_tensor(v, device=dev)
                for k, v in next(stream).items()}
    dcfg = DriverConfig(total_steps=args.steps, ckpt_dir=args.ckpt,
                        ckpt_every=max(args.steps // 4, 10))
    with pipe:
        result = train_loop(dcfg, step, params, opt_state, get_batch,
                            **({"put_batch": put_batch} if put_batch else {}))
    final = result.losses[-1] if result.losses else float("nan")
    print(f"[train] done: steps={result.final_step} final_loss={final:.4f} "
          f"resumed_from={result.resumed_from}")
    return result


if __name__ == "__main__":
    main()
