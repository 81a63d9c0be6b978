"""The plain reference: PyTorch operations only, in f32 with TF32 off
unless a control asks for a lower precision. It imports nothing of the
program and takes nothing the program made: the benchmark hands it the
same inputs and weights it hands the program, and it works out the
step's draws from (seed, step) itself."""
