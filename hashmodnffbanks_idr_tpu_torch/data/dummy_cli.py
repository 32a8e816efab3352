"""CLI for the dummy-scene generator (data/generate_dummy_data.py role).

    python -m hashmodnffbanks_idr_tpu_torch.data.dummy_cli --out data/dummy/scan0
"""

from __future__ import annotations

import argparse

from .dummy import generate_dummy_scene


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="data/dummy/scan0")
    p.add_argument("--views", type=int, default=10)
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--focal", type=float, default=70.0)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    generate_dummy_scene(args.out, n_views=args.views, image_size=args.size,
                         focal=args.focal, seed=args.seed)
    print(f"wrote dummy scene to {args.out}")


if __name__ == "__main__":
    main()
