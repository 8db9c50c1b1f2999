"""The plain reference the benchmark judges the port by.

Plain PyTorch in float32 with TF32 off (`exact_fp32`), attention computed
in blocks of queries so that the logits fit, no kernel and no cache.  It
reads the parameter trees the benchmark made (`avatar_bench/weights.py`)
and the raw inputs of a run, and works out everything else itself:
conditioning, embeddings, the schedule, the windows.  It imports nothing of
the program under test.
"""
