"""The topic model's inference side (port of :mod:`textgcn_tpu.topics`):
the stored vocabulary's vectorizer, the LDA E-step on a device, the
Word2Vec lookup and the ``TopicModel`` that loads the build stage's
pickle. Fitting (``LDA.fit``, CBOW training) is not ported yet."""
