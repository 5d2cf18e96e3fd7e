"""Training data: filelists, text and mel featurisation, collate, batching."""
