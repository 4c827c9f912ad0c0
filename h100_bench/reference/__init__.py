"""The benchmark's plain reference: the models (``model.py``), the
training step's loss, clip and AdamW (``train.py``) and the precision of
the controls (``precision.py``). Plain PyTorch, independent of the program
under test."""
