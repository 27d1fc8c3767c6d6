import sys

from mara3_tpu_torch.app.subprogram import main

if __name__ == "__main__":
    sys.exit(main())
