"""The topic model (port of :mod:`textgcn_tpu.topics`): the vectorizer, LDA
by batch VB-EM on a device, CBOW Word2Vec trained on a device, and the
``TopicModel`` that fits, saves and loads the build stage's pickle."""
