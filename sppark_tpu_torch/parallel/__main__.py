"""The sharded paths' dry run on every rank (parallel/dryrun.py):

    torchrun --nproc-per-node=N -m sppark_tpu_torch.parallel
    python3 -m sppark_tpu_torch.parallel --cpu   # a world of one, gloo
"""

import sys

from .dryrun import dryrun
from .mesh import destroy, init_distributed, make_mesh


def main(argv) -> int:
    init_distributed(device="cpu" if "--cpu" in argv else None)
    try:
        print(dryrun(make_mesh()), flush=True)
    finally:
        destroy()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
