import os
import sys

from stellar_tpu_torch.main.cli import main

try:
    sys.exit(main())
except BrokenPipeError:
    # downstream consumer (e.g. `| head`) closed the pipe mid-write;
    # point stdout at devnull so the interpreter-shutdown flush doesn't
    # hit the broken pipe again and taint the exit status
    os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
    sys.exit(0)
