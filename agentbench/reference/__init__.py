"""Plain f32 PyTorch references, one file per model family, named by a
configuration file's ``reference`` key.  They import nothing of the
program (``repro_torch``) and nothing of JAX.  Each module gives

    leaves(model) -> [weights.Leaf]   the weights it needs, by name
    logits(weights, model, seqs, precision) -> [(n, vocab), ...]

For each (tokens, prefill_len) of ``seqs`` (a prompt of ``prefill_len``
tokens and the tokens served after it), ``logits`` returns the f32 logits
at positions prefill_len - 1 .. len(tokens) - 1: the scores of each
served token.  ``precision`` is "f32" (the
reference; TF32 off) or "fp8" (the control: every product's operands
rounded to float8 e4m3 with a scale per row and per output column).
"""
