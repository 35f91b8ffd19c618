import sys

from cuda_ldpc_torch.cli import main

sys.exit(main())
