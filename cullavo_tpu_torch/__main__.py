"""``python -m cullavo_tpu_torch {train,eval,serve} --conf_files ...``: the
port's command line (``entry.main``), on the GPU."""
from cullavo_tpu_torch.entry import main

if __name__ == "__main__":
    main()
