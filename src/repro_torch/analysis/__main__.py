import sys

from repro_torch.analysis.cli import main

if __name__ == "__main__":  # importing the module (the hygiene test does) runs nothing
    sys.exit(main())
