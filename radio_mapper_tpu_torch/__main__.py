"""``python -m radio_mapper_tpu_torch``: the port's command-line runner."""

from radio_mapper_tpu_torch.cli import main

if __name__ == "__main__":
    main()
