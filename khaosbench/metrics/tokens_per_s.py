"""Net progress of the job over the window: the advance of its committed
stream cursor (work a rollback threw away does not count) times the
sequence length, over the window's seconds on the host's clock."""


def read(rec):
    return (rec.cursor_end - rec.cursor0) * rec.seq_len / rec.window_s
