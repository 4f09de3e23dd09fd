#!/usr/bin/env python3
"""Which gloo collectives take CUDA tensors, with two ranks on one card.

    python3 mesh_wire_probe.py

Two spawned processes, both on ``cuda:0``, in a gloo group on 127.0.0.1
(NCCL does not run two ranks on one device).  Each collective the
multi-device layer uses, and those it does not, runs once on small CUDA
tensors (``all_reduce`` SUM in f32, bf16, int8 and int32 and MAX in f32,
``all_gather`` in the same dtypes, ``reduce_scatter_tensor``,
``reduce_scatter``, ``all_gather_into_tensor``, ``broadcast``); then 256
MB of f32 by ``all_reduce`` and by ``all_gather`` (host clock, the card
synchronized, after one warm call); then a ``DeviceMesh`` on ``cuda``, a
``DTensor`` made from local shards and its ``full_tensor()``.  Each rank
prints each step as it starts and ends, so a collective that hangs shows
as the last ``start`` line; a 20 s group timeout turns a hung gloo
collective into an error, and the parent kills ranks still alive after
60 s.  Prints a JSON object of the results last.
"""
import datetime
import json
import multiprocessing as mp
import socket
import sys
import time


def _work(rank: int, world: int, port: int, q) -> None:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=20))
    res = {}

    def step(name, fn):
        print(rank, "start", name, flush=True)
        t0 = time.perf_counter()
        try:
            r = fn()
            torch.cuda.synchronize()
            res[name] = "ok" if r is None else r
        except Exception as e:  # noqa: BLE001 - recorded, not raised
            res[name] = "ERR " + repr(e)[:160]
        print(rank, "end", name, time.perf_counter() - t0, res[name],
              flush=True)

    def full(dt):
        return torch.full((1024,), rank + 1, dtype=dt, device="cuda")

    for dt in (torch.float32, torch.bfloat16, torch.int8, torch.int32):
        def reduce(dt=dt):
            t = full(dt)
            dist.all_reduce(t)
            return t[0].item()

        def gather(dt=dt):
            t = full(dt)
            parts = [torch.empty_like(t) for _ in range(world)]
            dist.all_gather(parts, t)
            return [p[0].item() for p in parts]

        step(f"all_reduce_sum_{dt}", reduce)
        step(f"all_gather_{dt}", gather)

    def reduce_max():
        t = torch.tensor(float(rank), device="cuda")
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return t.item()

    def scatter_tensor():
        out = torch.empty(2, device="cuda")
        dist.reduce_scatter_tensor(out, torch.ones(2 * world, device="cuda"))
        return out.tolist()

    def scatter_list():
        out = torch.empty(2, device="cuda")
        dist.reduce_scatter(out, [torch.ones(2, device="cuda")
                                  for _ in range(world)])
        return out.tolist()

    def gather_tensor():
        out = torch.empty(4 * world, device="cuda")
        dist.all_gather_into_tensor(out, torch.ones(4, device="cuda"))

    def broadcast():
        t = torch.full((4,), float(rank), device="cuda")
        dist.broadcast(t, 0)
        return t.tolist()

    step("all_reduce_max_f32", reduce_max)
    step("reduce_scatter_tensor", scatter_tensor)
    step("reduce_scatter", scatter_list)
    step("all_gather_into_tensor", gather_tensor)
    step("broadcast", broadcast)

    def seconds(fn):
        t = torch.ones(1 << 26, device="cuda")  # 256 MB of f32
        fn(t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(t)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    step("all_reduce_256MB_s", lambda: seconds(dist.all_reduce))
    step("all_gather_256MB_s", lambda: seconds(lambda t: dist.all_gather(
        [torch.empty_like(t) for _ in range(world)], t)))

    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    box = {}

    def mesh():
        box["mesh"] = init_device_mesh("cuda", (world, 1),
                                       mesh_dim_names=("data", "model"))
        return str(box["mesh"])

    def from_local():
        box["d"] = DTensor.from_local(
            torch.full((2, 3), float(rank), device="cuda"), box["mesh"],
            [Shard(0), Replicate()], run_check=False)
        return list(box["d"].shape)

    step("init_device_mesh_cuda", mesh)
    step("dtensor_from_local", from_local)
    q.put((rank, res))  # before the step that may hang
    step("dtensor_full_tensor", lambda: box["d"].full_tensor().tolist())
    dist.destroy_process_group()


def main() -> None:
    import torch

    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_work, args=(r, 2, port, q))
             for r in range(2)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in procs:
            rank, res = q.get(timeout=120)
            got[rank] = res
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    print(json.dumps({"ranks": got, "exit_codes": [p.exitcode
                                                   for p in procs]}))


if __name__ == "__main__":
    main()
