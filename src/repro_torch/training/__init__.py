"""Training for the port's models: AdamW (``optimizer``), the train step
(``train_loop``), checkpoints of the weights and AdamW's state
(``checkpoint``) and the reference's synthetic token stream (``data``, a
byte-equal copy of ``training/data.py`` of the JAX package)."""
