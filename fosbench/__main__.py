import sys

from fosbench.run import main

sys.exit(main())
