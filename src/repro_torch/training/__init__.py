"""QAT training: the step (``training.train``) and AdamW
(``training.optimizer``)."""
