"""The benchmark's plain reference: Wan2.1 T2V under a PTQ scheme and the
UniPC sampler, in plain PyTorch. Nothing here imports the program."""
