"""Training CLI — parity with code/training/exp_runner.py:7-45 and the JAX
package's ``train/exp_runner.py`` (same flags and defaults).

Usage:
    python -m hashmodnffbanks_idr_tpu_torch.train.exp_runner \
        --conf hashmodnffbanks_idr_tpu/config/confs/dummy_stylemodnffb.conf \
        --nepoch 30 --data_root data [--is_continue] [--platform cpu]

It trains on the CUDA card unless ``--platform cpu`` is given.  The
multi-host flags join the process group (``parallel/multihost.py:
initialize``; every process runs this same command with its own
``--process_id``).  As the JAX CLI does, it then builds the runner without
a mesh: each process trains the whole step on its own device, and rank 0
alone writes the run directory.  ``--trace_spans`` (the port's own) turns
the step's spans on (``utils/profiling.py``): each epoch's scalars then hold
``span_ms/<span>`` and ``launch_gap_ms``.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--nepoch", type=int, default=2000)
    p.add_argument("--conf", type=str, required=True)
    p.add_argument("--expname", type=str, default="")
    p.add_argument("--exps_folder_name", type=str, default="exps")
    p.add_argument("--is_continue", action="store_true")
    p.add_argument("--timestamp", type=str, default="latest")
    p.add_argument("--checkpoint", type=str, default="latest")
    p.add_argument("--train_cameras", action="store_true")
    p.add_argument("--scan_id", type=int, default=-1)
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--platform", type=str, default=None,
                   help="torch device to train on (default: the CUDA card; 'cpu')")
    p.add_argument("--no_tensorboard", action="store_true")
    p.add_argument("--coordinator", type=str, default=None,
                   help="host:port of process 0 for multi-process runs")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--trace_spans", action="store_true",
                   help="time the step's layers on the device and log span_ms/<span> and "
                        "launch_gap_ms an epoch")
    args = p.parse_args(argv)

    from ..parallel import multihost
    from .trainer import IDRTrainRunner

    multihost.initialize(args.coordinator, args.num_processes, args.process_id,
                         device=args.platform)

    runner = IDRTrainRunner(
        conf=args.conf,
        batch_size=args.batch_size,
        nepochs=args.nepoch,
        expname=args.expname,
        exps_folder_name=args.exps_folder_name,
        train_cameras=args.train_cameras,
        scan_id=args.scan_id,
        is_continue=args.is_continue,
        timestamp=args.timestamp,
        checkpoint=args.checkpoint,
        data_root=args.data_root,
        seed=args.seed,
        log_tensorboard=not args.no_tensorboard,
        device=args.platform,
        trace_spans=args.trace_spans,
    )
    runner.run()
    return runner


if __name__ == "__main__":
    main(sys.argv[1:])
