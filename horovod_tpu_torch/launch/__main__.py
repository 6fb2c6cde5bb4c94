"""``python -m horovod_tpu_torch.launch run --nprocs N -- <command>``."""

import sys

from horovod_tpu_torch.launch.launcher import main

if __name__ == "__main__":
    sys.exit(main())
