"""The loss, schedule, optimizer and train step of the port."""
