"""``python -m fire_tpu_torch``: the port's command line
(:mod:`fire_tpu_torch.cli`)."""

from fire_tpu_torch.cli import main

if __name__ == "__main__":
    main()
