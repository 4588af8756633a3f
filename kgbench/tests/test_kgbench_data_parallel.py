"""The four-chip cell's path on the CPU: four gloo ranks, each a process,
at a tiny size; a sound run is correct, and one with the gradient
all-reduce left out is not (rank 0's step then follows its own rows)."""

import argparse
import os
import socket

import torch.multiprocessing as mp

from kgbench.tests.conftest import tiny_cell

WORLD = 4


def rank_main(rank, port, broken, out):
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import torch

    torch.set_num_threads(1)
    from kgbench import run
    from kgbench.lib import check

    if broken:
        from ultra_torchdrug_tpu_torch.parallel import distributed

        distributed.all_reduce_mean = lambda flat: flat
    cell = tiny_cell("ultra.pretrain3g.dp4", steps_per_call=1)
    args = argparse.Namespace(seed=13, seconds=0.2, trace=0, port=port,
                              device="cpu")
    result = run.one_process(cell, args, rank, WORLD)
    if rank == 0:
        out.put(check.judge(result["numbers"], cell.limits)[0])


def spawn(broken: bool) -> bool:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    out = ctx.SimpleQueue()
    mp.start_processes(rank_main, args=(port, broken, out), nprocs=WORLD,
                       join=True, start_method="spawn")
    return out.get()


def test_sound_run_is_correct_and_a_missing_exchange_is_not():
    assert spawn(broken=False)
    assert not spawn(broken=True)
