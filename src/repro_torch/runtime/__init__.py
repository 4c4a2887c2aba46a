"""Train / serve step factories and the training driver."""
