"""The plain reference, one module a mode (``<mode>.py``, chosen by the
configuration's ``mode``), with the row sweep (``gotoh``) and what a chain
says (``alignment``) beside it. It imports nothing of the program and
takes nothing the program made: the benchmark hands it the same
sequences and scoring."""
