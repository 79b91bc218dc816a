"""The plain reference: the renderer's semantics in plain torch, with its
own random streams, imported by nothing of the program."""
