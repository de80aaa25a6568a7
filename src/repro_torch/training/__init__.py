"""Training for the port's decoders: AdamW (``optimizer``), the train step
(``train_loop``) and the reference's synthetic token stream (``data``, a
byte-equal copy of ``training/data.py`` of the JAX package)."""
