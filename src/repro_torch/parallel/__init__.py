"""Process groups and collectives of the EP group (torch.distributed)."""
