"""The benchmark's plain reference: plain PyTorch, float64 unless a control
asks for less, with no kernel, no cache and nothing of the program.

It works every answer out again from the generated inputs: each problem
is solved from the truth the generator drew (``lm.solve``), which the
program never sees, to the same minimum the program's solver seeks. The
program's outputs are only read to be judged (``judge``).
"""
