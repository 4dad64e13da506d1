"""Which collectives gloo carries on CUDA tensors: each op alone, in two gloo ranks that
share ``cuda:0`` (fresh interpreters; a crash ends only that op's pair).

Run on the card's machine::

    python -m tpu_resiliency_torch.scripts.gloo_cuda_probe [--ops all_reduce,...]
        [--route-all-gather]

Prints one line per op with the two ranks' exit codes (``-11`` a segfault) and the
first failing rank's last lines, then ``GLOO_CUDA {...}``. ``--route-all-gather``
registers, in each rank, a CUDA kernel for ``_c10d_functional.all_gather_into_tensor``
that calls the plain ``dist.all_gather_into_tensor``: the functional ops then run
through it (``__graft_entry__.GLOO_CUDA_REFUSED`` records what fails without it).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

OPS = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
       "reduce_scatter_tensor", "reduce_scatter", "all_to_all_single", "send_recv", "barrier",
       "device_mesh", "funcol_all_gather", "funcol_reduce_scatter", "funcol_all_reduce",
       "dtensor_tp_matmul")


def _route_all_gather():
    import torch
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    def all_gather_into_tensor(inp, group_size, group_name):
        out = inp.new_empty((inp.shape[0] * group_size, *inp.shape[1:]))
        dist.all_gather_into_tensor(out, inp.contiguous(), group=_resolve_process_group(group_name))
        return out

    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", all_gather_into_tensor, "CUDA")
    return lib


def _rank(op: str, rank: int, port: int, route: bool) -> None:
    import faulthandler
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    faulthandler.enable()
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2, timeout=timedelta(seconds=60))
    kept = _route_all_gather() if route else None  # noqa: F841 (the registration lives with it)
    d = torch.device("cuda", 0)
    x = torch.full((4, 8), float(rank + 1), device=d)
    if op == "all_reduce":
        dist.all_reduce(x)
    elif op == "broadcast":
        dist.broadcast(x, 0)
    elif op == "all_gather":
        dist.all_gather([torch.empty_like(x) for _ in range(2)], x)
    elif op == "all_gather_into_tensor":
        dist.all_gather_into_tensor(torch.empty((8, 8), device=d), x)
    elif op == "reduce_scatter_tensor":
        dist.reduce_scatter_tensor(torch.empty((2, 8), device=d), x)
    elif op == "reduce_scatter":
        dist.reduce_scatter(torch.empty((4, 8), device=d), [x, x.clone()])
    elif op == "all_to_all_single":
        dist.all_to_all_single(torch.empty_like(x), x)
    elif op == "send_recv":
        if rank == 0:
            dist.send(x, 1)
        else:
            dist.recv(x, 0)
    elif op == "barrier":
        dist.barrier()
    elif op == "device_mesh":
        from torch.distributed.device_mesh import DeviceMesh

        DeviceMesh("cuda", torch.arange(2), mesh_dim_names=("tp",))
    elif op.startswith("funcol_"):
        import torch.distributed._functional_collectives as fc

        g = dist.group.WORLD
        if op == "funcol_all_gather":
            y = fc.all_gather_tensor(x, 0, g)
        elif op == "funcol_reduce_scatter":
            y = fc.reduce_scatter_tensor(x, "sum", 0, g)
        else:
            y = fc.all_reduce(x, "sum", g)
        fc.wait_tensor(y)
    elif op == "dtensor_tp_matmul":
        from torch.distributed.device_mesh import DeviceMesh
        from torch.distributed.tensor import Replicate, Shard, distribute_tensor

        mesh = DeviceMesh("cuda", torch.arange(2), mesh_dim_names=("tp",))
        w = distribute_tensor(torch.ones(8, 8, device=d, requires_grad=True), mesh, [Shard(1)])
        a = distribute_tensor(torch.ones(4, 8, device=d), mesh, [Replicate()])
        (a @ w).full_tensor().sum().backward()
    else:
        raise ValueError(f"unknown op {op!r}")
    torch.cuda.synchronize()
    dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ops", default=",".join(OPS))
    ap.add_argument("--route-all-gather", action="store_true")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        _rank(args.ops, args.rank, args.port, args.route_all_gather)
        return 0

    from tpu_resiliency_torch.platform.distributed import reserve_port

    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    route = ["--route-all-gather"] if args.route_all_gather else []
    codes = {}
    for op in args.ops.split(","):
        port, held = reserve_port()
        procs = [subprocess.Popen([sys.executable, "-m", "tpu_resiliency_torch.scripts."
                                   "gloo_cuda_probe", "--ops", op, "--rank", str(r), "--port",
                                   str(port), *route], stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True, env=env, cwd=repo)
                 for r in range(2)]
        outs = []
        for p in procs:
            try:
                _, err = p.communicate(timeout=120)
            except subprocess.TimeoutExpired:
                p.kill()
                _, err = p.communicate()
            outs.append((p.returncode, err))
        held.close()
        codes[op] = [rc for rc, _ in outs]
        print(op, codes[op], flush=True)
        failed = [err for rc, err in outs if rc != 0]
        if failed:
            print("   " + failed[0][-1200:].replace("\n", "\n   "), flush=True)
    print("GLOO_CUDA " + json.dumps(codes), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
