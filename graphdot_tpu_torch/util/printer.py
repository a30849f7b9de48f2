"""Markdown table printer used by verbose training loops (fills the role
of the reference's ``graphdot/util/printer.py``). A copy of
``graphdot_tpu/util/printer.py``, unchanged."""


class markdown:
    """Stateful row printer: emits a header row once per table."""

    _pending_header = False

    @classmethod
    def table_start(cls):
        """Begin a new table; the next ``table`` call prints a header."""
        cls._pending_header = True

    @staticmethod
    def _render(fields):
        """Format one data row and matching header/separator rows."""
        cells = [fmt % value for _, fmt, value in fields]
        titles = []
        for (title, fmt, _), cell in zip(fields, cells):
            align = '-' if fmt.startswith('%-') else ''
            titles.append(f'%{align}{len(cell)}s' % title)
        rules = ['-' * len(c) for c in cells]
        return cells, titles, rules

    @classmethod
    def table_header(cls, *fields):
        """Print only the header and separator rows."""
        _, titles, rules = cls._render(fields)
        print('|' + '|'.join(titles) + '|')
        print('|' + '|'.join(rules) + '|')

    @classmethod
    def table(cls, *fields, print_header='auto'):
        """Print one data row; prepend a header when starting a table or
        when ``print_header=True``."""
        want_header = (
            print_header is True
            or (print_header == 'auto' and cls._pending_header)
        )
        cells, titles, rules = cls._render(fields)
        if want_header:
            print('|' + '|'.join(titles) + '|')
            print('|' + '|'.join(rules) + '|')
            cls._pending_header = False
        print('|' + '|'.join(cells) + '|')
