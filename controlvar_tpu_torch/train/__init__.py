"""Training: lr/wd schedules, weight-decay groups and the train step."""
