"""Training: FOCAL loss, optimizer and schedule, train state, the pretrain step."""
