"""Workload models (port of ``dpf_tpu/models``).

``datasets`` and ``loaders`` make and parse the access patterns (copies
of ``dpf_tpu``'s numpy code); ``rec`` (CTR model, ROC-AUC) and ``lm``
(LSTM language model, perplexity) train in ``torch.nn`` and evaluate with
the embeddings a batch-PIR plan failed to recover masked to zero -- the
paper's accuracy-vs-PIR-budget study; ``checkpoint`` saves and restores
their ``state_dict``; ``init`` holds flax's default initializers.  Entry
points take ``device=None``, which means CUDA.
"""
