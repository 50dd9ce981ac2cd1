"""Mean recall@10 over every answer of the window against the exact top 10
(the reference's, in float64).  Every answer to a query is checked equal
to the first, so each query's first answer counts as often as it was
given."""


def read(record):
    return record["recall_at_10"]
